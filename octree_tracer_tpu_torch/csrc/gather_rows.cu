// K8 `gather_rows`: out[i * rows + r, :] = table[starts[i] + r, :].
//
// Replaces every row gather and row copy of the probes' Pallas kernels:
// probes/gather_probe.py:177 `p4_mosaic` (pallas_call :264, :298, :323) and
// :345 `p5_mosaic_round3` (:401, :435), and probes/pallas_min_probe.py `t5`
// (:108), `t6`-`t10b` (:128, :159, :187, :221, :254, :280), `t11` (:319, also
// run by t11s, t11g, t13), `t12` (:370) and `t14` (:446, also t14b). On the
// TPU those differ only in how the row DMAs are issued (per-row copies with K
// outstanding, BlockSpec index maps, a VMEM-resident take); on Hopper they
// are one function, so one kernel file serves them all.
//
// The table is u32[G, w] (int32 bits), any w; starts are i32[n], checked on
// the host to lie in [0, G - rows]. The `rows` table rows from a start are
// contiguous, so start i copies one segment of rows * w words from table row
// starts[i] to output row i * rows. What bounds it on the H100: bytes, each
// distinct table row the starts reach read once, each output row written
// once, 4 bytes a start, at 3.35 TB/s. A random row costs a whole 32-byte
// sector at least, so rows of 8 words reach the bound only if the memory
// serves random sectors at its streaming rate; the one-block probe lines
// (4-512 KB) are bound by the launch and the kernel's critical path (a start
// load, then a row load, then a store).
//
// Design. The host (probes/gather.py `gather_plan`) picks one of two kernels
// and the grid from the shapes and addresses; no thread divides by a runtime
// value on the probes' path, and stores are marked evict-first
// (st.global.cs), so that the output streaming through the L2 does not push
// table rows out. Blocks are 256 threads.
// - flat_kernel, one thread a 16-byte vector (or a word): the segment by a
//   shift when its length is a power of two, else by one division. Used
//   while one vector a thread fills the card in one wave (the one-block
//   lines: each thread's critical path is one start load, one row load, one
//   store), for tables within a sixteenth of the L2 (their rows are L2
//   hits, and the L2's request rate, not latency, sets the time), and for
//   widths that are no multiple of 4, pointers that are not 16-byte aligned
//   and segments of one vector or of no power-of-two length.
// - tile_kernel, for larger gathers of 16-byte vectors and power-of-two
//   segments of two vectors or more (8- and 128-word rows): a warp owns a
//   tile of 64 consecutive output vectors. Its lanes load the tile's starts
//   in one coalesced access and pass them by __shfl_sync; each lane then has
//   two independent 16-byte loads in flight before its stores. The segment
//   and vector of an output vector come by shifts and masks. Rows of 8
//   words: 16 rows a load instruction, 32 a warp; rows of 128 words: a warp
//   per row, two rows a warp in flight.
// Offsets are 32-bit wherever the table and output allow, else 64-bit.
// Measured and dropped (PERF.md, Findings): four and eight loads a lane, a
// capped grid striding over the tiles, blocks of 128, stores without the
// evict-first hint, and Hopper's bulk asynchronous copies (cp.async.bulk)
// through a shared-memory ring, which lost at every shape.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kU = 2;  // vectors a lane of tile_kernel keeps in flight
constexpr int kTile = 32 * kU;

// Segments of 2^log_seg >= kU vectors, so a tile reaches at most 32 starts.
template <typename I>
__global__ void __launch_bounds__(kBlock) tile_kernel(const uint4* __restrict__ table,
                                                      const int32_t* __restrict__ starts,
                                                      uint4* __restrict__ out, I n_starts,
                                                      I row_vecs, int log_seg) {
  const int lane = threadIdx.x & 31;
  const I total = n_starts << log_seg;
  const I v0 = (static_cast<I>(blockIdx.x) * (kBlock / 32) + (threadIdx.x >> 5)) * kTile;
  if (v0 >= total) return;  // the whole warp
  const I seg_mask = (static_cast<I>(1) << log_seg) - 1;
  const I s0 = v0 >> log_seg;
  const int need = log_seg < 16 ? max(kTile >> log_seg, 1) : 1;  // starts the tile reaches
  const int32_t st = lane < need && s0 + lane < n_starts ? __ldg(starts + s0 + lane) : 0;
  uint4 v[kU];
#pragma unroll
  for (int k = 0; k < kU; ++k) {
    const I j = v0 + lane + 32 * k;
    const int sl = static_cast<int>((j >> log_seg) - s0);
    const int32_t s = __shfl_sync(0xffffffffu, st, sl & 31);
    if (j < total) v[k] = __ldg(table + static_cast<I>(s) * row_vecs + (j & seg_mask));
  }
#pragma unroll
  for (int k = 0; k < kU; ++k) {
    const I j = v0 + lane + 32 * k;
    if (j < total) __stcs(out + j, v[k]);
  }
}

// One unit a thread: the segment by a shift (kLog, power-of-two segments)
// or one division.
template <typename T, typename I, bool kLog>
__global__ void __launch_bounds__(kBlock) flat_kernel(const T* __restrict__ table,
                                                      const int32_t* __restrict__ starts,
                                                      T* __restrict__ out, I total, I seg,
                                                      int log_seg, I row_units) {
  const I t = static_cast<I>(blockIdx.x) * kBlock + threadIdx.x;
  if (t >= total) return;
  const I i = kLog ? t >> log_seg : t / seg;
  __stcs(out + t, table[static_cast<I>(__ldg(starts + i)) * row_units + (t - i * seg)]);
}

template <typename T, typename I>
void launch_flat(const void* table, const int32_t* starts, void* out, int64_t total,
                 int64_t seg, int log_seg, int64_t row_units, unsigned blocks, cudaStream_t st) {
  const auto* t = static_cast<const T*>(table);
  auto* o = static_cast<T*>(out);
  const I n = static_cast<I>(total), sg = static_cast<I>(seg), ru = static_cast<I>(row_units);
  if (log_seg >= 0)
    flat_kernel<T, I, true><<<blocks, kBlock, 0, st>>>(t, starts, o, n, sg, log_seg, ru);
  else
    flat_kernel<T, I, false><<<blocks, kBlock, 0, st>>>(t, starts, o, n, sg, log_seg, ru);
}

template <typename I>
void launch_tile(const void* table, const int32_t* starts, int64_t n_starts, void* out,
                 int64_t row_vecs, int log_seg, unsigned blocks, cudaStream_t st) {
  tile_kernel<I><<<blocks, kBlock, 0, st>>>(static_cast<const uint4*>(table), starts,
                                            static_cast<uint4*>(out), static_cast<I>(n_starts),
                                            static_cast<I>(row_vecs), log_seg);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// table u32[G, w]; starts i32[n_starts], each in [0, G - rows]; out
// u32[n_starts * rows, w]: out segment i (seg units) = table from row
// starts[i]. A unit is a 16-byte vector if `vector`, else a word; a table
// row is row_units units; log_seg = log2(seg), or -1. As planned by the
// host: tile_kernel if `tile` (vectors and log_seg >= 1), else flat_kernel;
// `blocks` blocks of 256 threads; 64-bit offsets if `wide`. Returns a
// cudaError_t.
extern "C" int ot_gather_rows(const void* table, const void* starts, int64_t n_starts,
                              void* out, int tile, int vector, int64_t row_units, int64_t seg,
                              int log_seg, int64_t blocks, int wide, void* stream) {
  if (n_starts == 0 || seg == 0 || blocks == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const int32_t*>(starts);
  const bool pow2 = log_seg >= 0 && log_seg < 62 && (int64_t{1} << log_seg) == seg;
  if (blocks > 0x7fffffff || (tile && !(vector && pow2 && log_seg >= 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vector && !(aligned16(table) && aligned16(out)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto nb = static_cast<unsigned>(blocks);
  if (tile) {
    if (wide) launch_tile<int64_t>(table, s, n_starts, out, row_units, log_seg, nb, st);
    else launch_tile<uint32_t>(table, s, n_starts, out, row_units, log_seg, nb, st);
  } else {
    const int64_t total = n_starts * seg;
    const int ls = pow2 ? log_seg : -1;
    if (vector && wide)
      launch_flat<uint4, int64_t>(table, s, out, total, seg, ls, row_units, nb, st);
    else if (vector)
      launch_flat<uint4, uint32_t>(table, s, out, total, seg, ls, row_units, nb, st);
    else if (wide)
      launch_flat<uint32_t, int64_t>(table, s, out, total, seg, ls, row_units, nb, st);
    else
      launch_flat<uint32_t, uint32_t>(table, s, out, total, seg, ls, row_units, nb, st);
  }
  return static_cast<int>(cudaGetLastError());
}
