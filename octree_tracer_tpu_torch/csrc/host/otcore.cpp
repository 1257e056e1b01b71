// otcore — native host runtime for octree_tracer_tpu.
//
// The TPU owns the per-ray compute; this library owns the host-side hot
// paths that the reference implements in Rust (src/octree.rs, src/adaptive.rs,
// src/cpu_octree.rs, src/world.rs): per-candidate adaptive subdivision /
// collapse against the world's ground-truth chunks, insertion-order octree
// builds, .rsvo breadth-first expansion, and mip-tree generation. All buffers
// are caller-owned numpy arrays (little-endian u32 / f32); growable results
// use an opaque handle + copy-out pattern so Python keeps ownership of the
// final storage.
//
// Build: make -C octree_tracer_tpu/native   ->  libotcore.so (C ABI, ctypes).

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kVoxelOffset = 134217728u;   // 2^27 (src/octree.rs:5)
constexpr uint32_t kChunkOffset = 2147483648u;  // 2^31 (src/cpu_octree.rs:3)
constexpr uint32_t kRed = 255u << 16;

inline uint32_t payload(uint32_t word) { return word >> 4; }
inline uint32_t leaf_word(uint32_t rgb) { return (kVoxelOffset + rgb) << 4; }

inline void child_offset(int child, int depth, float out[3]) {
  const float inv = 1.0f / float(1u << depth);
  out[0] = (float((child >> 2) & 1) * 2.0f - 1.0f) * inv;
  out[1] = (float((child >> 1) & 1) * 2.0f - 1.0f) * inv;
  out[2] = (float(child & 1) * 2.0f - 1.0f) * inv;
}

struct Buf {
  std::vector<uint32_t> ptrs;
  std::vector<uint32_t> vals;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Streamed pool (GPU octree mirror). All arrays owned by Python:
//   nodes u32[cap], positions f32[cap*3], holes u32[hole_cap].
// Patches: slot indices whose words changed (Python re-reads the values).
// ---------------------------------------------------------------------------

struct OtPool {
  uint32_t* nodes;
  float* positions;
  uint64_t len;
  uint64_t cap;
  uint32_t* holes;
  uint64_t hole_len;
  uint64_t hole_cap;
};

// World chunk views for the adaptive pass: chunk id -> (ptrs, vals) arrays.
struct OtChunk {
  uint32_t id;
  uint32_t n;
  const uint32_t* ptrs;
  const uint32_t* vals;
};

// Point-location descent in the streamed pool (src/octree.rs:113-141, >=).
static void pool_find_voxel(const OtPool* p, const float pos[3],
                            uint32_t max_depth, uint64_t* out_idx,
                            uint32_t* out_depth) {
  uint64_t node_index = 0;
  float node_pos[3] = {0, 0, 0};
  uint32_t depth = 0;
  for (;;) {
    depth += 1;
    const int cx = pos[0] >= node_pos[0], cy = pos[1] >= node_pos[1],
              cz = pos[2] >= node_pos[2];
    const int child = cx * 4 + cy * 2 + cz;
    float off[3];
    child_offset(child, depth, off);
    node_pos[0] += off[0];
    node_pos[1] += off[1];
    node_pos[2] += off[2];
    const uint64_t idx = node_index + child;
    const uint32_t pay = payload(p->nodes[idx]);
    if (pay >= kVoxelOffset || depth == max_depth) {
      *out_idx = idx;
      *out_depth = depth;
      return;
    }
    node_index = pay;
  }
}

// Cross-chunk world descent (src/world.rs:201-232, >=). Returns 0 on success;
// 1 if a chunk on the path is not resident.
static int world_find_voxel(const OtChunk* chunks, uint64_t n_chunks,
                            const float pos[3], uint32_t max_depth,
                            uint32_t* out_chunk, uint64_t* out_idx) {
  std::unordered_map<uint32_t, const OtChunk*> map;
  map.reserve(n_chunks);
  for (uint64_t i = 0; i < n_chunks; i++) map[chunks[i].id] = &chunks[i];

  uint32_t chunk = 0;
  uint64_t node_index = 0;
  float node_pos[3] = {0, 0, 0};
  uint32_t depth = 0;
  for (;;) {
    depth += 1;
    const int cx = pos[0] >= node_pos[0], cy = pos[1] >= node_pos[1],
              cz = pos[2] >= node_pos[2];
    const int child = cx * 4 + cy * 2 + cz;
    float off[3];
    child_offset(child, depth, off);
    node_pos[0] += off[0];
    node_pos[1] += off[1];
    node_pos[2] += off[2];
    auto it = map.find(chunk);
    if (it == map.end()) return 1;
    const OtChunk* c = it->second;
    const uint64_t idx = node_index + child;
    if (idx >= c->n) return 1;
    const uint32_t tnipt = c->ptrs[idx];
    if (tnipt == kChunkOffset || depth == max_depth) {
      *out_chunk = chunk;
      *out_idx = idx;
      return 0;
    } else if (tnipt > kChunkOffset) {
      chunk = tnipt - kChunkOffset;
      node_index = 0;
    } else {
      node_index = tnipt;
    }
  }
}

static void pool_subdivide(OtPool* p, uint64_t node, const uint32_t mask[8],
                           uint32_t depth, std::vector<uint32_t>* patches) {
  uint64_t index;
  if (p->hole_len > 0) {
    index = p->holes[--p->hole_len];
  } else {
    index = p->len;
    p->len += 8;  // caller guarantees capacity
  }
  p->nodes[node] = uint32_t(index) << 4;
  const float* ppos = &p->positions[node * 3];
  for (int i = 0; i < 8; i++) {
    p->nodes[index + i] = leaf_word(mask[i]);
    float off[3];
    child_offset(i, depth, off);
    p->positions[(index + i) * 3 + 0] = ppos[0] + off[0];
    p->positions[(index + i) * 3 + 1] = ppos[1] + off[1];
    p->positions[(index + i) * 3 + 2] = ppos[2] + off[2];
  }
  patches->push_back(uint32_t(node));
  for (int i = 0; i < 8; i++) patches->push_back(uint32_t(index + i));
}

// Adaptive subdivision pass (src/adaptive.rs:6-68). Candidates end at the
// first negative entry. Returns the number of splits applied. Chunk ids that
// need streaming land in `missing` (capped, deduplicated by caller).
int64_t otc_process_subdivision(OtPool* pool, const int32_t* cand,
                                uint64_t n_cand, const OtChunk* chunks,
                                uint64_t n_chunks, uint32_t* patches,
                                uint64_t* n_patches, uint64_t patch_cap,
                                uint32_t* missing, uint64_t* n_missing,
                                uint64_t missing_cap) {
  std::vector<uint32_t> patch_list;
  int64_t applied = 0;
  *n_missing = 0;
  for (uint64_t i = 0; i < n_cand; i++) {
    const int32_t c = cand[i];
    if (c < 0) break;
    if (uint64_t(c) >= pool->len) continue;
    if (payload(pool->nodes[c]) < kVoxelOffset) continue;  // "Doubleup!"

    const float* pos = &pool->positions[uint64_t(c) * 3];
    uint64_t vidx;
    uint32_t vdepth;
    pool_find_voxel(pool, pos, UINT32_MAX, &vidx, &vdepth);

    uint32_t wchunk;
    uint64_t widx;
    if (world_find_voxel(chunks, n_chunks, pos, vdepth, &wchunk, &widx) != 0)
      continue;
    const OtChunk* cv = nullptr;
    for (uint64_t k = 0; k < n_chunks; k++)
      if (chunks[k].id == wchunk) cv = &chunks[k];
    if (!cv) continue;
    const uint32_t ptr = cv->ptrs[widx];

    if (ptr < kChunkOffset) {
      uint32_t mask[8];
      for (int m = 0; m < 8; m++) mask[m] = cv->vals[ptr + m];
      pool_subdivide(pool, uint64_t(c), mask, vdepth + 1, &patch_list);
      applied++;
    } else if (ptr > kChunkOffset) {
      const uint32_t ref = ptr - kChunkOffset;
      const OtChunk* rv = nullptr;
      for (uint64_t k = 0; k < n_chunks; k++)
        if (chunks[k].id == ref) rv = &chunks[k];
      if (rv && rv->n >= 8) {
        uint32_t mask[8];
        for (int m = 0; m < 8; m++) mask[m] = rv->vals[m];
        pool_subdivide(pool, uint64_t(c), mask, vdepth + 1, &patch_list);
        applied++;
      } else if (*n_missing < missing_cap) {
        missing[(*n_missing)++] = ref;
      }
    }
  }
  const uint64_t n = patch_list.size() < patch_cap ? patch_list.size() : patch_cap;
  std::memcpy(patches, patch_list.data(), n * sizeof(uint32_t));
  *n_patches = n;
  return applied;
}

// Adaptive collapse pass (src/adaptive.rs:70-126). Evictable generated-chunk
// ids land in `evict`.
int64_t otc_process_unsubdivision(OtPool* pool, const int32_t* cand,
                                  uint64_t n_cand, const OtChunk* chunks,
                                  uint64_t n_chunks, uint32_t* patches,
                                  uint64_t* n_patches, uint64_t patch_cap,
                                  uint32_t* evict, uint64_t* n_evict,
                                  uint64_t evict_cap) {
  std::vector<uint32_t> patch_list;
  int64_t applied = 0;
  *n_evict = 0;
  for (uint64_t i = 0; i < n_cand; i++) {
    const int32_t c = cand[i];
    if (c < 0) break;
    if (uint64_t(c) >= pool->len) continue;
    const uint32_t pay = payload(pool->nodes[c]);
    if (pay >= kVoxelOffset) continue;  // already a leaf

    // unsubdivide: reclaim the child group (src/octree.rs:95-110)
    if (pool->hole_len < pool->hole_cap) pool->holes[pool->hole_len++] = pay;
    pool->nodes[c] = leaf_word(kRed);

    const float* pos = &pool->positions[uint64_t(c) * 3];
    uint64_t vidx;
    uint32_t vdepth;
    pool_find_voxel(pool, pos, UINT32_MAX, &vidx, &vdepth);

    uint32_t wchunk;
    uint64_t widx;
    uint32_t value = 0;
    if (world_find_voxel(chunks, n_chunks, pos, vdepth, &wchunk, &widx) == 0) {
      const OtChunk* cv = nullptr;
      for (uint64_t k = 0; k < n_chunks; k++)
        if (chunks[k].id == wchunk) cv = &chunks[k];
      if (cv) {
        const uint32_t ptr = cv->ptrs[widx];
        value = cv->vals[widx];
        if (ptr > kChunkOffset) {
          const uint32_t ref = ptr - kChunkOffset;
          if (ref >= kChunkOffset / 2 && *n_evict < evict_cap)
            evict[(*n_evict)++] = ref;
        }
      }
    }
    pool->nodes[c] = leaf_word(value);
    patch_list.push_back(uint32_t(c));
    applied++;
  }
  const uint64_t n = patch_list.size() < patch_cap ? patch_list.size() : patch_cap;
  std::memcpy(patches, patch_list.data(), n * sizeof(uint32_t));
  *n_patches = n;
  return applied;
}

// ---------------------------------------------------------------------------
// Insertion-order CpuOctree builder (put_in_voxel loop semantics,
// src/cpu_octree.rs:100-111): node layout identical to the reference's
// sequential inserts, for byte-compatible .bin output.
// ---------------------------------------------------------------------------

static void buf_add_voxels(Buf* b, uint8_t mask) {
  const size_t base = b->ptrs.size();
  for (int i = 0; i < 8; i++) {
    if ((mask >> i) & 1) {
      b->ptrs.push_back(kChunkOffset + uint32_t((base + i) % 8) + 1);
      b->vals.push_back(kRed);
    } else {
      b->ptrs.push_back(kChunkOffset);
      b->vals.push_back(0);
    }
  }
}

static void buf_put_leaf(Buf* b, const float pos[3], uint32_t leaf_ptr,
                         uint32_t leaf_val, uint32_t depth) {
  for (;;) {
    uint64_t node_index = 0;
    float node_pos[3] = {0, 0, 0};
    uint32_t d = 0;
    uint64_t idx;
    for (;;) {
      d += 1;
      const int cx = pos[0] >= node_pos[0], cy = pos[1] >= node_pos[1],
                cz = pos[2] >= node_pos[2];
      const int child = cx * 4 + cy * 2 + cz;
      float off[3];
      child_offset(child, d, off);
      node_pos[0] += off[0];
      node_pos[1] += off[1];
      node_pos[2] += off[2];
      idx = node_index + child;
      if (b->ptrs[idx] >= kChunkOffset) break;
      node_index = b->ptrs[idx];
    }
    if (d == depth) {
      b->ptrs[idx] = leaf_ptr;
      b->vals[idx] = leaf_val;
      return;
    }
    b->ptrs[idx] = uint32_t(b->ptrs.size());
    buf_add_voxels(b, 0);
  }
}

void* otc_build_leaves(const float* pos, const uint32_t* leaf_ptrs,
                       const uint32_t* leaf_vals, uint64_t n, uint32_t depth) {
  Buf* b = new Buf();
  buf_add_voxels(b, 0);
  for (uint64_t i = 0; i < n; i++)
    buf_put_leaf(b, &pos[i * 3], leaf_ptrs[i], leaf_vals[i], depth);
  return b;
}

// Stamp leaves into an EXISTING tree (structure placement onto generated
// chunks, gen/structures.py): copy the caller's SoA into a growable Buf and
// run the same descent-split insert the Python put_in_block loop performs —
// identical insertion order, so the result is bit-identical to the Python
// fallback (tests/test_native.py).
void* otc_stamp_leaves(const uint32_t* ptrs, const uint32_t* vals, uint64_t n,
                       const float* pos, const uint32_t* leaf_ptrs,
                       const uint32_t* leaf_vals, uint64_t m, uint32_t depth) {
  Buf* b = new Buf();
  b->ptrs.assign(ptrs, ptrs + n);
  b->vals.assign(vals, vals + n);
  for (uint64_t i = 0; i < m; i++)
    buf_put_leaf(b, &pos[i * 3], leaf_ptrs[i], leaf_vals[i], depth);
  return b;
}

// ---------------------------------------------------------------------------
// Dense-grid level-synchronous octree build (the procedural generator's hot
// path; replaces host argsort+unique over tens of millions of morton codes).
// Input: a 2-bit-packed S^3 block-id grid (S = 2^depth), C-order [x][y][z],
// 16 cells per u32, cell i in bits [2i, 2i+1]; block ids are 0 (empty),
// 1 (stone) or 3 (grass) — exactly representable in 2 bits. Output layout is
// BIT-IDENTICAL to io/vox.py build_octree_leaves(cells, CHUNK_OFFSET+block,
// 0, depth): BFS group allocation in morton order per level (a preorder DFS
// that visits children in (x<<2|y<<1|z) order enumerates each level's
// occupied nodes in exactly that sorted-prefix order). Leaves become block
// references (CHUNK_OFFSET + id, 0) — put_in_block semantics, reference:
// src/cpu_octree.rs:87-111, src/procedual.wgsl:189-201.
// ---------------------------------------------------------------------------

namespace {

struct DenseBuild {
  const uint32_t* packed;
  uint32_t depth;
  uint32_t side;
  // masks[L][cell] = 8-bit child-occupancy mask of the level-L node at
  // `cell` (bit c = child (x<<2|y<<1|z) occupied), L = 0..depth-1; level 0
  // is the single root "node" whose children are the level-1 cells. A node
  // is occupied iff its mask is nonzero (leaves handled from `packed`).
  std::vector<std::vector<uint8_t>> masks;
  std::vector<uint64_t> starts;  // starts[L] = slot base of level-(L+1) groups
  std::vector<uint64_t> rank;    // running DFS rank per level
  Buf* out;

  inline uint32_t cell(uint64_t x, uint64_t y, uint64_t z) const {
    const uint64_t i = (x * side + y) * side + z;
    return (packed[i >> 4] >> ((i & 15u) * 2u)) & 3u;
  }

  void visit(uint32_t level, uint64_t x, uint64_t y, uint64_t z,
             uint64_t slot, uint8_t mask) {
    // `mask` is this node's child-occupancy mask (level < depth).
    const uint64_t base = starts[level] + 8 * rank[level]++;
    out->ptrs[slot] = uint32_t(base);
    const uint64_t s2 = uint64_t(1) << (level + 1);
    for (int c = 0; c < 8; c++) {
      if (!((mask >> c) & 1)) continue;
      const uint64_t x2 = x * 2 + ((c >> 2) & 1);
      const uint64_t y2 = y * 2 + ((c >> 1) & 1);
      const uint64_t z2 = z * 2 + (c & 1);
      if (level + 1 == depth) {
        out->ptrs[base + c] = kChunkOffset + cell(x2, y2, z2);
        out->vals[base + c] = 0;
      } else {
        visit(level + 1, x2, y2, z2, base + c,
              masks[level + 1][(x2 * s2 + y2) * s2 + z2]);
      }
    }
  }
};

}  // namespace

void* otc_build_dense(const uint32_t* packed, uint32_t depth) {
  DenseBuild d;
  d.packed = packed;
  d.depth = depth;
  d.side = 1u << depth;
  d.out = new Buf();
  if (depth < 1) return d.out;

  // Child-mask mips, bottom-up, all linear passes. Level depth-1 reads the
  // packed leaves: the two z-children of a cell are ADJACENT 2-bit lanes
  // (packing is along z), so each parent cell touches 4 words.
  d.masks.resize(depth);
  {
    const uint32_t level = depth - 1;
    const uint64_t s = uint64_t(1) << level;
    std::vector<uint8_t>& m = d.masks[level];
    m.assign(s * s * s, 0);
    const uint64_t S = d.side;
    for (uint64_t x = 0; x < s; x++)
      for (uint64_t y = 0; y < s; y++)
        for (uint64_t z = 0; z < s; z++) {
          uint8_t mask = 0;
          for (int dx = 0; dx < 2; dx++)
            for (int dy = 0; dy < 2; dy++) {
              const uint64_t i = ((2 * x + dx) * S + (2 * y + dy)) * S + 2 * z;
              const uint32_t w = packed[i >> 4] >> ((i & 15u) * 2u);
              const int c = dx * 4 + dy * 2;
              if (w & 3u) mask |= uint8_t(1u << c);
              if (w & 12u) mask |= uint8_t(1u << (c + 1));
            }
          m[(x * s + y) * s + z] = mask;
        }
  }
  for (uint32_t level = depth - 1; level >= 1; level--) {
    const uint64_t s = uint64_t(1) << (level - 1);
    const uint64_t s2 = s * 2;
    std::vector<uint8_t>& m = d.masks[level - 1];
    const std::vector<uint8_t>& chl = d.masks[level];
    m.assign(s * s * s, 0);
    for (uint64_t x = 0; x < s; x++)
      for (uint64_t y = 0; y < s; y++)
        for (uint64_t z = 0; z < s; z++) {
          uint8_t mask = 0;
          for (int c = 0; c < 8; c++) {
            const uint64_t x2 = 2 * x + ((c >> 2) & 1);
            const uint64_t y2 = 2 * y + ((c >> 1) & 1);
            const uint64_t z2 = 2 * z + (c & 1);
            if (chl[(x2 * s2 + y2) * s2 + z2]) mask |= uint8_t(1u << c);
          }
          m[(x * s + y) * s + z] = mask;
        }
  }

  // Group bases: level-1 group (root) plus one level-(L+1) group per
  // occupied level-L node, L = 1..depth-1 (io/vox.py:160-164). An occupied
  // node is one with a nonzero mask (level < depth nodes always have
  // occupied descendants by construction).
  std::vector<uint64_t> group_counts(depth, 0);
  group_counts[0] = 1;
  for (uint32_t level = 1; level < depth; level++) {
    uint64_t n = 0;
    for (uint8_t v : d.masks[level]) n += (v != 0);
    group_counts[level] = n;
  }
  d.starts.assign(depth + 1, 0);
  for (uint32_t level = 1; level <= depth; level++)
    d.starts[level] = d.starts[level - 1] + group_counts[level - 1] * 8;
  const uint64_t total = d.starts[depth];
  d.out->ptrs.assign(total, kChunkOffset);
  d.out->vals.assign(total, 0);
  d.rank.assign(depth + 1, 0);

  const uint8_t root_mask = d.masks[0][0];
  for (int c = 0; c < 8; c++) {
    if (!((root_mask >> c) & 1)) continue;
    const uint64_t x = (c >> 2) & 1, y = (c >> 1) & 1, z = c & 1;
    if (depth == 1) {
      d.out->ptrs[c] = kChunkOffset + d.cell(x, y, z);
      d.out->vals[c] = 0;
    } else {
      d.visit(1, x, y, z, uint64_t(c), d.masks[1][(x * 2 + y) * 2 + z]);
    }
  }
  return d.out;
}

// ---------------------------------------------------------------------------
// .rsvo breadth-first expansion (src/cpu_octree.rs:128-175).
// ---------------------------------------------------------------------------

void* otc_load_rsvo(const uint8_t* masks, uint64_t n_masks, uint64_t node_end) {
  Buf* b = new Buf();
  if (n_masks == 0) return b;
  buf_add_voxels(b, masks[0]);
  uint64_t data_index = 1;
  for (uint64_t node = 0; node < b->ptrs.size(); node++) {
    if (b->ptrs[node] > kChunkOffset) {
      if (data_index < node_end && data_index < n_masks) {
        const uint8_t mask = masks[data_index];
        b->ptrs[node] = uint32_t(b->ptrs.size());
        buf_add_voxels(b, mask);
      }
      data_index++;
    }
  }
  return b;
}

uint64_t otc_buf_len(void* h) { return static_cast<Buf*>(h)->ptrs.size(); }

void otc_buf_copy(void* h, uint32_t* ptrs_out, uint32_t* vals_out) {
  Buf* b = static_cast<Buf*>(h);
  std::memcpy(ptrs_out, b->ptrs.data(), b->ptrs.size() * sizeof(uint32_t));
  std::memcpy(vals_out, b->vals.data(), b->vals.size() * sizeof(uint32_t));
}

void otc_buf_free(void* h) { delete static_cast<Buf*>(h); }

// ---------------------------------------------------------------------------
// Mip-tree generation (src/world.rs:234-336): BFS catalog + bottom-up
// non-empty average with the >=1 clamp. Chunk-ref values must be pre-patched
// by the caller (it owns the chunk registry); this averages in place and
// returns the top mip.
// ---------------------------------------------------------------------------

uint32_t otc_mip_tree(const uint32_t* ptrs, uint32_t* vals, uint64_t n) {
  std::vector<std::vector<uint64_t>> levels;
  std::vector<uint64_t> frontier;
  for (uint64_t i = 0; i < 8 && i < n; i++)
    if (ptrs[i] < kChunkOffset) frontier.push_back(i);
  while (!frontier.empty()) {
    levels.push_back(frontier);
    std::vector<uint64_t> next;
    for (uint64_t idx : frontier) {
      const uint64_t base = ptrs[idx];
      for (int c = 0; c < 8; c++)
        if (base + c < n && ptrs[base + c] < kChunkOffset)
          next.push_back(base + c);
    }
    frontier.swap(next);
  }

  auto average = [&](uint64_t base) -> uint32_t {
    float r = 0, g = 0, bl = 0, div = 0;
    for (int c = 0; c < 8; c++) {
      const uint32_t v = vals[base + c];
      if (v != 0) {
        r += float((v >> 16) & 0xFF);
        g += float((v >> 8) & 0xFF);
        bl += float(v & 0xFF);
        div += 1.0f;
      }
    }
    auto clamp1 = [](float x, float d) -> uint32_t {
      if (d == 0.0f) return 1;  // NaN -> 0 -> max(1) in the reference
      uint32_t t = uint32_t(x / d);
      return t < 1 ? 1 : (t > 255 ? 255 : t);
    };
    return (clamp1(r, div) << 16) | (clamp1(g, div) << 8) | clamp1(bl, div);
  };

  for (auto it = levels.rbegin(); it != levels.rend(); ++it)
    for (uint64_t idx : *it) vals[idx] = average(ptrs[idx]);
  return average(0);
}

// ---------------------------------------------------------------------------
// Chunk-reference mip patching (src/world.rs:246-255): every node whose
// pointer references chunk id in `ids` gets that chunk's top-mip colour
// written into `vals`. One linear pass; `ids` must be sorted ascending.
// Replaces a numpy nonzero+unique+fancy-index sequence that cost ~24 s on an
// 80M-slot chunk (vs ~0.5 s here, 1-core host).
// ---------------------------------------------------------------------------

void otc_patch_refs(const uint32_t* ptrs, uint32_t* vals, uint64_t n,
                    const uint32_t* ids, const uint32_t* mips, uint32_t k) {
  if (k == 0) return;
  uint32_t last_id = 0xFFFFFFFFu, last_mip = 0;
  bool last_hit = false;
  for (uint64_t i = 0; i < n; i++) {
    const uint32_t p = ptrs[i];
    if (p <= kChunkOffset) continue;
    const uint32_t id = p - kChunkOffset;
    if (id != last_id) {
      last_id = id;
      uint32_t lo = 0, hi = k;
      while (lo < hi) {
        const uint32_t mid = (lo + hi) / 2;
        if (ids[mid] < id) lo = mid + 1; else hi = mid;
      }
      last_hit = lo < k && ids[lo] == id;
      last_mip = last_hit ? mips[lo] : 0;
    }
    if (last_hit) vals[i] = last_mip;
  }
}

}  // extern "C"
