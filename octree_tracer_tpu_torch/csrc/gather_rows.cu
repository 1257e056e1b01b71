// K8 `gather_rows`: out[i * rows + r, :] = table[starts[i] + r, :].
//
// Replaces every row gather and row copy of the probes' Pallas kernels:
// probes/gather_probe.py:177 `p4_mosaic` (pallas_call :264, :298, :323) and
// :345 `p5_mosaic_round3` (:401, :435), and probes/pallas_min_probe.py `t5`
// (:108), `t6`-`t10b` (:128, :159, :187, :221, :254, :280), `t11` (:319, also
// run by t11s, t11g, t13), `t12` (:370) and `t14` (:446, also t14b). On the
// TPU those differ only in how the row DMAs are issued (per-row copies with K
// outstanding, BlockSpec index maps, a VMEM-resident take); on Hopper they
// are one function, so one kernel serves them all.
//
// The table is u32[G, w] (int32 bits), any w; starts are i32[n], checked on
// the host to lie in [0, G - rows]. What bounds it on the H100: bytes, each
// output row read once from the table and written once, plus 4 index bytes a
// start: n * rows * 8w + 4n bytes at 3.35 TB/s. A random row costs a whole
// 32-byte sector at least, so rows of 8 words (32 B) reach the bound only if
// the DRAM serves random sectors at its streaming rate; a table that fits the
// 50 MB L2 can beat it after the first touch.
//
// Design: when w is a multiple of 4 and both pointers are 16-byte aligned,
// each thread moves one 16-byte vector (2 threads a row of 8 words, 32 a row
// of 128), neighbouring threads on neighbouring addresses; otherwise one
// thread a word. A thread reads its row's start itself (the TPU kernels
// prefetched them into scalar memory).
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(ot::kBlock) gather_kernel(
    const T* __restrict__ table, const int32_t* __restrict__ starts,
    T* __restrict__ out, int64_t n_out, int64_t per_row, int rows) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_out) return;
  const int64_t orow = t / per_row;
  const int64_t c = t - orow * per_row;
  const int64_t i = orow / rows;
  const int64_t src = static_cast<int64_t>(starts[i]) + (orow - i * rows);
  out[t] = table[src * per_row + c];
}

}  // namespace

// table u32[G, width]; starts i32[n_starts], each in [0, G - rows]; out
// u32[n_starts * rows, width]. Returns cudaGetLastError().
extern "C" int ot_gather_rows(const void* table, int64_t width, const void* starts,
                              int64_t n_starts, int rows, void* out, void* stream) {
  const int64_t n_rows = n_starts * rows;
  if (n_rows == 0 || width == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const int32_t*>(starts);
  const bool vec = width % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0
                   && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    const int64_t per_row = width / 4;
    gather_kernel<<<ot::blocks_for(n_rows * per_row), ot::kBlock, 0, st>>>(
        static_cast<const uint4*>(table), s, static_cast<uint4*>(out), n_rows * per_row,
        per_row, rows);
  } else {
    gather_kernel<<<ot::blocks_for(n_rows * width), ot::kBlock, 0, st>>>(
        static_cast<const uint32_t*>(table), s, static_cast<uint32_t*>(out), n_rows * width,
        width, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
