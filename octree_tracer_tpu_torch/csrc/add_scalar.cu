// K9 `add_scalar`: out = x + c, f32 or u32 (int32 bits, wrapping).
//
// Replaces the elementwise Pallas kernels of probes/pallas_min_probe.py: `t1`
// (pallas_call :44, f32[8, 128] + 1), `t2` (:54, u32[8, 128] + 1), `t3` (:64,
// u32[1024, 128] + 1 in (128, 128) blocks) and `t4` (:87, + s[0] from a
// scalar-prefetch operand). The scalar comes by value or, for t4, as a
// pointer to one element on the device, read by every thread.
//
// What bounds it on the H100: bytes, 2 x 4 bytes an element at 3.35 TB/s.
// At the probes' shapes (4 KB to 512 KB) that is 2.4-313 ns, far under a
// launch, so the time it shows is launch latency. It could be Triton; it is
// CUDA so that all the port's kernels share one nvcc build. One thread an
// element.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(ot::kBlock) add_kernel(const T* __restrict__ x,
                                                         T* __restrict__ out, int64_t n, T c,
                                                         const T* __restrict__ c_ptr) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = x[i] + (c_ptr != nullptr ? *c_ptr : c);
}

template <typename T>
int launch(const void* x, void* out, int64_t n, T c, const void* c_ptr, void* stream) {
  if (n == 0) return 0;
  add_kernel<<<ot::blocks_for(n), ot::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, c, static_cast<const T*>(c_ptr));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out f32[n] = x + (c_ptr ? *c_ptr : c). Returns cudaGetLastError().
extern "C" int ot_add_scalar_f32(const void* x, void* out, int64_t n, float c,
                                 const void* c_ptr, void* stream) {
  return launch<float>(x, out, n, c, c_ptr, stream);
}

// out u32[n] = x + (c_ptr ? *c_ptr : c), modulo 2^32.
extern "C" int ot_add_scalar_u32(const void* x, void* out, int64_t n, uint32_t c,
                                 const void* c_ptr, void* stream) {
  return launch<uint32_t>(x, out, n, c, c_ptr, stream);
}
