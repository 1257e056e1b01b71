// K5 `select_candidates`: LOD candidate selection over the node pool.
//
// Replaces the XLA program of octree_tracer_tpu/adaptive/feedback.py:33-92
// (`select_candidates`, `select_candidates_packed`) with its `fast_nonzero`
// compaction (render/tracer.py:69-96). Per slot: counter = min(visits, 15);
// a valid (word != 0, slot < node_len) filled leaf with counter >= 4 is a
// subdivide candidate, a valid interior with counter 0 a collapse candidate.
// Each list is compacted in the rotated slot order (position j holds slot
// (j + offset) % n), ascending, up to its cap. The output is one int32 array
// [sub_n, unsub_n, sub_idx[sub_cap], unsub_idx[unsub_cap]]: the counts are
// not capped, unused entries are -1.
//
// The order is part of the result (the Session's offset rotation reads the
// last consumed index), so the compaction is a deterministic scan. It reads
// each slot once: a single-pass chained scan with decoupled look-back
// (Merrill and Garland), one block a work item. The work items are the
// pool's tiles of kTile slots, aligned in slot space so that words and
// visits arrive as 16-byte vectors, taken in the rotated order; the tile
// that holds `offset` is split into a head (slots >= offset, the first item)
// and a tail (slots < offset, the last item, empty when offset starts a
// tile): ceil(n / kTile) + 1 items, whose ranges list the rotated positions
// once each and in order. Within an item a slot's rank is its block's
// exclusive prefix from the look-back plus a block scan of per-lane counts,
// so the result does not depend on the order in which blocks run. Blocks
// take their item from a ticket counter, so every item a block waits on
// belongs to a block that is already running.
//
// One memset of 0xFF bytes before the launch fills the output with -1 and
// resets the item status words and the ticket, so no status of an earlier
// call is read. What bounds it on the H100: bytes, 8 a slot read once plus
// the output written twice (memset, then candidates).
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kVecs = 4;                     // 16-byte vectors a lane
constexpr int kWarpSlots = 32 * 4 * kVecs;   // 512 slots a warp
constexpr int kTile = kWarps * kWarpSlots;   // 4096 slots a block (SELECT_TILE)

// A work item's status word: flag in bits 62-63, the subdivide count in bits
// 31-61, the collapse count in bits 0-30. All ones (the memset) is "not
// ready"; an aggregate covers the item alone, a prefix every item up to and
// including it.
constexpr int kFlagShift = 62;
constexpr unsigned long long kAggregate = 1ull, kPrefix = 2ull, kNotReady = 3ull;
constexpr unsigned kMask31 = 0x7FFFFFFFu;

struct SelArgs {
  const uint32_t* words;
  const int32_t* visits;
  int64_t n;
  int64_t node_len;
  int64_t offset;  // in [0, n)
  int64_t n_tiles;
  int sub_cap;
  int unsub_cap;
  int32_t* out;                 // [2 + sub_cap + unsub_cap]
  unsigned long long* status;   // [n_tiles + 1], all ones on entry
  unsigned* ticket;             // all ones on entry
};

__device__ __forceinline__ unsigned long long pack_status(unsigned long long flag,
                                                          unsigned sub, unsigned unsub) {
  return (flag << kFlagShift) | (static_cast<unsigned long long>(sub) << 31) | unsub;
}

__device__ __forceinline__ unsigned status_flag(unsigned long long s) {
  return static_cast<unsigned>(s >> kFlagShift);
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *static_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long s) {
  *static_cast<volatile unsigned long long*>(p) = s;
}

// Bits of the subdivide and collapse verdicts of slot s: 1 and 2.
__device__ __forceinline__ unsigned verdict(const SelArgs& a, int64_t s, uint32_t word,
                                            int32_t visits) {
  const uint32_t payload = word >> 4;
  const int32_t counter = min(visits, 15);
  const bool valid = word != 0u && s < a.node_len;
  return (valid && counter >= 4 && payload > ot::kVoxelOffset ? 1u : 0u) |
         (valid && counter == 0 && payload < ot::kVoxelOffset ? 2u : 0u);
}

// This lane's verdict masks (bit k of sub[v] / unsub[v] for slot
// seg + 128 v + k) over the item's range [lo, hi) of the tile at base. A
// whole tile starts its eight 16-byte loads before it uses any.
template <bool kVec>
__device__ __forceinline__ void lane_masks(const SelArgs& a, int64_t base, int64_t seg,
                                           int64_t lo, int64_t hi, unsigned sub[kVecs],
                                           unsigned unsub[kVecs]) {
  if (kVec && lo == base && hi == base + kTile) {
    uint4 wv[kVecs];
    int4 vv[kVecs];
    for (int v = 0; v < kVecs; ++v) {
      wv[v] = __ldg(reinterpret_cast<const uint4*>(a.words + seg + v * 128));
      vv[v] = __ldg(reinterpret_cast<const int4*>(a.visits + seg + v * 128));
    }
    for (int v = 0; v < kVecs; ++v) {
      const int64_t s0 = seg + v * 128;
      const uint32_t w[4] = {wv[v].x, wv[v].y, wv[v].z, wv[v].w};
      const int32_t c[4] = {vv[v].x, vv[v].y, vv[v].z, vv[v].w};
      unsigned sb = 0u, ub = 0u;
      for (int k = 0; k < 4; ++k) {
        const unsigned d = verdict(a, s0 + k, w[k], c[k]);
        sb |= (d & 1u) << k;
        ub |= (d >> 1) << k;
      }
      sub[v] = sb;
      unsub[v] = ub;
    }
    return;
  }
  for (int v = 0; v < kVecs; ++v) {
    const int64_t s0 = seg + v * 128;
    unsigned sb = 0u, ub = 0u;
    if (s0 + 4 > lo && s0 < hi) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      int32_t c[4] = {0, 0, 0, 0};
      if (kVec && s0 + 4 <= a.n) {
        const uint4 wq = __ldg(reinterpret_cast<const uint4*>(a.words + s0));
        const int4 cq = __ldg(reinterpret_cast<const int4*>(a.visits + s0));
        w[0] = wq.x; w[1] = wq.y; w[2] = wq.z; w[3] = wq.w;
        c[0] = cq.x; c[1] = cq.y; c[2] = cq.z; c[3] = cq.w;
      } else {
        for (int k = 0; k < 4; ++k) {
          if (s0 + k < a.n) {
            w[k] = a.words[s0 + k];
            c[k] = a.visits[s0 + k];
          }
        }
      }
      for (int k = 0; k < 4; ++k) {
        const int64_t s = s0 + k;
        const unsigned d = s >= lo && s < hi ? verdict(a, s, w[k], c[k]) : 0u;
        sb |= (d & 1u) << k;
        ub |= (d >> 1) << k;
      }
    }
    sub[v] = sb;
    unsub[v] = ub;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) select_kernel(const SelArgs a) {
  __shared__ unsigned warp_sub[kWarps], warp_unsub[kWarps];
  __shared__ unsigned item_shared;
  __shared__ unsigned excl_sub_shared, excl_unsub_shared;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) item_shared = atomicAdd(a.ticket, 1u) + 1u;  // from all ones
  __syncthreads();
  const int64_t item = item_shared;

  // The item's slot range [lo, hi) inside one tile.
  const int64_t k0 = a.offset / kTile;
  const int64_t tile = item == a.n_tiles ? k0 : (k0 + item) % a.n_tiles;
  const int64_t base = tile * kTile;
  const int64_t lo = item == 0 ? a.offset : base;
  const int64_t hi = item == a.n_tiles ? a.offset : min(base + kTile, a.n);

  // Slots of this lane: base + warp * 512 + v * 128 + lane * 4 + k, so the
  // order (warp, v, lane, k) is slot order and each load is coalesced.
  const int64_t seg = base + static_cast<int64_t>(warp) * kWarpSlots + lane * 4;
  unsigned sub[kVecs], unsub[kVecs];
  lane_masks<kVec>(a, base, seg, lo, hi, sub, unsub);

  // Warp scan of the per-lane counts, eight 8-bit fields (a field sums at
  // most 128): sub of vector v at bits 8v, unsub at 32 + 8v.
  unsigned long long mine = 0ull;
  for (int v = 0; v < kVecs; ++v) {
    mine |= static_cast<unsigned long long>(__popc(sub[v])) << (8 * v);
    mine |= static_cast<unsigned long long>(__popc(unsub[v])) << (32 + 8 * v);
  }
  unsigned long long incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  const unsigned long long total = __shfl_sync(0xffffffffu, incl, 31);
  const unsigned long long excl = incl - mine;
  // Rank of this lane's first candidate of vector v within the warp.
  unsigned r_sub[kVecs], r_unsub[kVecs];
  unsigned acc_sub = 0u, acc_unsub = 0u;
  for (int v = 0; v < kVecs; ++v) {
    r_sub[v] = acc_sub + static_cast<unsigned>((excl >> (8 * v)) & 0xFFu);
    r_unsub[v] = acc_unsub + static_cast<unsigned>((excl >> (32 + 8 * v)) & 0xFFu);
    acc_sub += static_cast<unsigned>((total >> (8 * v)) & 0xFFu);
    acc_unsub += static_cast<unsigned>((total >> (32 + 8 * v)) & 0xFFu);
  }
  if (lane == 0) {
    warp_sub[warp] = acc_sub;
    warp_unsub[warp] = acc_unsub;
  }
  __syncthreads();
  unsigned before_sub = 0u, before_unsub = 0u, agg_sub = 0u, agg_unsub = 0u;
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) {
      before_sub = agg_sub;
      before_unsub = agg_unsub;
    }
    agg_sub += warp_sub[w];
    agg_unsub += warp_unsub[w];
  }

  // Decoupled look-back: publish the aggregate, then walk back over the
  // preceding items, 32 at a time, until one has published its prefix.
  if (warp == 0) {
    unsigned ex_sub = 0u, ex_unsub = 0u;
    if (item == 0) {
      if (lane == 0) store_status(&a.status[0], pack_status(kPrefix, agg_sub, agg_unsub));
    } else {
      if (lane == 0) store_status(&a.status[item], pack_status(kAggregate, agg_sub, agg_unsub));
      for (int64_t top = item - 1;; top -= 32) {
        const int64_t idx = top - lane;
        // Before item 0 lies an empty prefix.
        unsigned long long s = pack_status(kPrefix, 0u, 0u);
        if (idx >= 0) s = load_status(&a.status[idx]);
        for (;;) {
          const bool wait = status_flag(s) == kNotReady;
          if (!__any_sync(0xffffffffu, wait)) break;
          if (wait) s = load_status(&a.status[idx]);
        }
        const unsigned prefixes = __ballot_sync(0xffffffffu, status_flag(s) == kPrefix);
        const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
        unsigned ps = lane <= stop ? static_cast<unsigned>(s >> 31) & kMask31 : 0u;
        unsigned pu = lane <= stop ? static_cast<unsigned>(s) & kMask31 : 0u;
        for (int o = 16; o > 0; o >>= 1) {
          ps += __shfl_xor_sync(0xffffffffu, ps, o);
          pu += __shfl_xor_sync(0xffffffffu, pu, o);
        }
        ex_sub += ps;
        ex_unsub += pu;
        if (prefixes) break;
      }
      if (lane == 0) {
        store_status(&a.status[item],
                     pack_status(kPrefix, ex_sub + agg_sub, ex_unsub + agg_unsub));
      }
    }
    if (lane == 0) {
      excl_sub_shared = ex_sub;
      excl_unsub_shared = ex_unsub;
      if (item == a.n_tiles) {  // the last item: the uncapped totals
        a.out[0] = static_cast<int32_t>(ex_sub + agg_sub);
        a.out[1] = static_cast<int32_t>(ex_unsub + agg_unsub);
      }
    }
  }
  __syncthreads();

  const unsigned item_sub = excl_sub_shared + before_sub;
  const unsigned item_unsub = excl_unsub_shared + before_unsub;
  int32_t* sub_out = a.out + 2;
  int32_t* unsub_out = a.out + 2 + a.sub_cap;
  for (int v = 0; v < kVecs; ++v) {
    unsigned rs = item_sub + r_sub[v], ru = item_unsub + r_unsub[v];
    const int32_t s0 = static_cast<int32_t>(seg + v * 128);
    for (int k = 0; k < 4; ++k) {
      if ((sub[v] >> k) & 1u) {
        if (rs < static_cast<unsigned>(a.sub_cap)) sub_out[rs] = s0 + k;
        ++rs;
      }
      if ((unsub[v] >> k) & 1u) {
        if (ru < static_cast<unsigned>(a.unsub_cap)) unsub_out[ru] = s0 + k;
        ++ru;
      }
    }
  }
}

}  // namespace

// words u32[n], visits i32[n]; scratch: (n_tiles + 1) 8-byte status words
// then a 4-byte ticket, n_tiles = ceil(n / kTile),
// directly followed by out i32[2 + sub_cap + unsub_cap], the whole span
// `scratch_bytes` long; offset in [0, n); vec: words and visits are 16-byte
// aligned. One memset and one launch on the stream; returns the first error.
extern "C" int ot_select_candidates(const void* words, const void* visits, int64_t n,
                                    int64_t node_len, int64_t offset, int sub_cap,
                                    int unsub_cap, void* scratch, int64_t scratch_bytes,
                                    void* out, int vec, void* stream) {
  if (n == 0) return 0;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  const SelArgs a{static_cast<const uint32_t*>(words),
                  static_cast<const int32_t*>(visits),
                  n,
                  node_len,
                  offset,
                  n_tiles,
                  sub_cap,
                  unsub_cap,
                  static_cast<int32_t*>(out),
                  static_cast<unsigned long long*>(scratch),
                  reinterpret_cast<unsigned*>(static_cast<unsigned long long*>(scratch) +
                                              n_tiles + 1)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0xFF, static_cast<size_t>(scratch_bytes), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(n_tiles + 1);
  if (vec) {
    select_kernel<true><<<grid, kThreads, 0, s>>>(a);
  } else {
    select_kernel<false><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
