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
// last consumed index), so the compaction is a deterministic scan, in three
// launches: per-block counts, one block scanning the block totals, then a
// scatter in which every block places its candidates at its scanned base.
// What bounds it on the H100: bytes, 8 per slot read twice (words and
// visits, in the count and the scatter launch) plus 4 per candidate written;
// the scan of block totals is one block's work.
#include "common.cuh"

namespace {

constexpr int kItems = 8;                // consecutive positions per thread
constexpr int kChunk = ot::kBlock * kItems;  // 2048 positions per block
constexpr int kScanBlock = 1024;

struct SelArgs {
  const uint32_t* words;
  const int32_t* visits;
  int64_t n;
  int64_t node_len;
  int64_t offset;  // in [0, n)
  int sub_cap;
  int unsub_cap;
  int32_t* out;    // [2 + sub_cap + unsub_cap]
};

// Exclusive prefix sum of v over the block in thread order; *total gets the
// block's sum. Every thread of the block must call it (blockDim.x a multiple
// of 32, at most 1024).
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < n_warps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums may be reused by the next call
  return before;
}

// The masks of the kItems positions from j0: bit k of *sub / *unsub is
// position j0 + k's verdict, slot[k] its slot.
__device__ __forceinline__ void thread_masks(const SelArgs& a, int64_t j0,
                                             int64_t slot[kItems], unsigned* sub,
                                             unsigned* unsub) {
  *sub = 0u;
  *unsub = 0u;
  for (int k = 0; k < kItems; ++k) {
    const int64_t j = j0 + k;
    slot[k] = 0;
    if (j >= a.n) continue;
    int64_t s = j + a.offset;
    if (s >= a.n) s -= a.n;
    slot[k] = s;
    const uint32_t word = a.words[s];
    const int32_t counter = min(a.visits[s], 15);
    const uint32_t payload = word >> 4;
    const bool valid = word != 0u && s < a.node_len;
    if (valid && counter >= 4 && payload > ot::kVoxelOffset) *sub |= 1u << k;
    if (valid && counter == 0 && payload < ot::kVoxelOffset) *unsub |= 1u << k;
  }
}

__global__ void __launch_bounds__(ot::kBlock) count_kernel(const SelArgs a,
                                                           int32_t* block_counts) {
  __shared__ int warp_sums[32];
  int64_t slot[kItems];
  unsigned sub, unsub;
  thread_masks(a, static_cast<int64_t>(blockIdx.x) * kChunk + threadIdx.x * kItems,
               slot, &sub, &unsub);
  int total_sub, total_unsub;
  block_exclusive_scan(__popc(sub), warp_sums, &total_sub);
  block_exclusive_scan(__popc(unsub), warp_sums, &total_unsub);
  if (threadIdx.x == 0) {
    block_counts[2 * blockIdx.x] = total_sub;
    block_counts[2 * blockIdx.x + 1] = total_unsub;
  }
}

// One block: block_counts becomes each block's exclusive base, out[0..1]
// the (uncapped) totals.
__global__ void __launch_bounds__(kScanBlock) scan_kernel(int32_t* block_counts,
                                                          int n_blocks, int32_t* out) {
  __shared__ int warp_sums[32];
  int carry_sub = 0, carry_unsub = 0;
  for (int base = 0; base < n_blocks; base += blockDim.x) {
    const int b = base + threadIdx.x;
    const int c_sub = b < n_blocks ? block_counts[2 * b] : 0;
    const int c_unsub = b < n_blocks ? block_counts[2 * b + 1] : 0;
    int t_sub, t_unsub;
    const int e_sub = block_exclusive_scan(c_sub, warp_sums, &t_sub);
    const int e_unsub = block_exclusive_scan(c_unsub, warp_sums, &t_unsub);
    if (b < n_blocks) {
      block_counts[2 * b] = carry_sub + e_sub;
      block_counts[2 * b + 1] = carry_unsub + e_unsub;
    }
    carry_sub += t_sub;
    carry_unsub += t_unsub;
  }
  if (threadIdx.x == 0) {
    out[0] = carry_sub;
    out[1] = carry_unsub;
  }
}

__global__ void __launch_bounds__(ot::kBlock) scatter_kernel(const SelArgs a,
                                                             const int32_t* block_base) {
  __shared__ int warp_sums[32];
  int64_t slot[kItems];
  unsigned sub, unsub;
  thread_masks(a, static_cast<int64_t>(blockIdx.x) * kChunk + threadIdx.x * kItems,
               slot, &sub, &unsub);
  int unused;
  int r_sub = block_exclusive_scan(__popc(sub), warp_sums, &unused) +
              block_base[2 * blockIdx.x];
  int r_unsub = block_exclusive_scan(__popc(unsub), warp_sums, &unused) +
                block_base[2 * blockIdx.x + 1];
  int32_t* sub_out = a.out + 2;
  int32_t* unsub_out = a.out + 2 + a.sub_cap;
  for (int k = 0; k < kItems; ++k) {
    if ((sub >> k) & 1u) {
      if (r_sub < a.sub_cap) sub_out[r_sub] = static_cast<int32_t>(slot[k]);
      ++r_sub;
    }
    if ((unsub >> k) & 1u) {
      if (r_unsub < a.unsub_cap) unsub_out[r_unsub] = static_cast<int32_t>(slot[k]);
      ++r_unsub;
    }
  }
  // Entries past the totals are -1 (disjoint from the candidates' entries).
  const int n_sub = a.out[0], n_unsub = a.out[1];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < static_cast<int64_t>(a.sub_cap) + a.unsub_cap; r += stride) {
    if (r < a.sub_cap) {
      if (r >= n_sub) sub_out[r] = -1;
    } else if (r - a.sub_cap >= n_unsub) {
      unsub_out[r - a.sub_cap] = -1;
    }
  }
}

}  // namespace

// words u32[n], visits i32[n]; block_counts i32[2 * ceil(n / kChunk)] scratch
// (feedback.SELECT_CHUNK on the host); out i32[2 + sub_cap + unsub_cap];
// offset in [0, n). Three launches on the stream; returns cudaGetLastError().
extern "C" int ot_select_candidates(const void* words, const void* visits, int64_t n,
                                    int64_t node_len, int64_t offset, int sub_cap,
                                    int unsub_cap, void* block_counts, void* out,
                                    void* stream) {
  if (n == 0) return 0;
  const SelArgs a{static_cast<const uint32_t*>(words),
                  static_cast<const int32_t*>(visits),
                  n,
                  node_len,
                  offset,
                  sub_cap,
                  unsub_cap,
                  static_cast<int32_t*>(out)};
  const int n_blocks = static_cast<int>((n + kChunk - 1) / kChunk);
  int32_t* counts = static_cast<int32_t*>(block_counts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  count_kernel<<<n_blocks, ot::kBlock, 0, s>>>(a, counts);
  scan_kernel<<<1, kScanBlock, 0, s>>>(counts, n_blocks, a.out);
  scatter_kernel<<<n_blocks, ot::kBlock, 0, s>>>(a, counts);
  return static_cast<int>(cudaGetLastError());
}
