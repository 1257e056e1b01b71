// K9 `add_scalar`: out = x + c, f32 or u32 (int32 bits, wrapping).
//
// Replaces the elementwise Pallas kernels of probes/pallas_min_probe.py: `t1`
// (pallas_call :44, f32[8, 128] + 1), `t2` (:54, u32[8, 128] + 1), `t3` (:64,
// u32[1024, 128] + 1 in (128, 128) blocks) and `t4` (:87, + s[0] from a
// scalar-prefetch operand). The scalar comes by value or, for t4, as a
// pointer to one element on the device.
//
// What bounds it on the H100: bytes, 2 x 4 bytes an element at 3.35 TB/s.
// At the probes' shapes (4 KB to 512 KB) that is 2.4-313 ns, far under a
// launch, so what the card shows is the launch, the block count and the
// kernel's own critical path (the scalar, one load, one store). It could be
// Triton; it is CUDA so that all the port's kernels share one nvcc build.
//
// Design: each thread moves one 16-byte vector (4 elements) in blocks of
// 256, so t3's 32,768 vectors take 128 blocks (two and four vectors a
// thread, blocks of 64 and 128, and one element a thread measured slower:
// PERF.md, Findings). The host (probes/gather.py `add_plan`) splits x: the
// first `head` elements (0-3) lie before the first 16-byte boundary of x
// and out (the wrapper gives out x's alignment), the `tail` (0-3) after the
// last vector, and both are done one element a thread by block 0 of an
// instantiation that has edges; 32-bit offsets unless n needs 64. By
// pointer (a template parameter, not a test in the thread) the scalar is
// read through the read-only path beside the vector load, so the two loads
// overlap.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ uint4 add4(uint4 v, uint32_t c) {
  return make_uint4(v.x + c, v.y + c, v.z + c, v.w + c);
}
__device__ __forceinline__ float4 add4(float4 v, float c) {
  return make_float4(v.x + c, v.y + c, v.z + c, v.w + c);
}

template <typename T> struct Vec4;
template <> struct Vec4<uint32_t> { using type = uint4; };
template <> struct Vec4<float> { using type = float4; };

// Vector blockIdx.x * kBlock + threadIdx.x of the aligned middle, then
// (block 0, if kEdges) the head and tail elements.
template <typename T, typename I, bool kByPtr, bool kEdges>
__global__ void __launch_bounds__(kBlock) add_kernel(const T* __restrict__ x,
                                                     T* __restrict__ out, I head, I n_vec,
                                                     I tail, T c, const T* __restrict__ c_ptr) {
  using V = typename Vec4<T>::type;
  if (kByPtr) c = __ldg(c_ptr);
  const V* __restrict__ xv = reinterpret_cast<const V*>(x + head);
  V* __restrict__ ov = reinterpret_cast<V*>(out + head);
  const I j = static_cast<I>(blockIdx.x) * kBlock + threadIdx.x;
  if (j < n_vec) ov[j] = add4(__ldg(xv + j), c);
  if (kEdges && blockIdx.x == 0) {
    const I t = threadIdx.x;
    if (t < head) out[t] = x[t] + c;
    else if (t >= 4 && t < 4 + tail) {
      const I e = head + 4 * n_vec + (t - 4);
      out[e] = x[e] + c;
    }
  }
}

template <typename T, typename I, bool kByPtr>
void launch_typed(const T* x, T* out, int64_t head, int64_t n_vec, int64_t tail,
                  unsigned blocks, T c, const T* c_ptr, cudaStream_t st) {
  const I h = static_cast<I>(head), nv = static_cast<I>(n_vec), tl = static_cast<I>(tail);
  if (head != 0 || tail != 0)
    add_kernel<T, I, kByPtr, true><<<blocks, kBlock, 0, st>>>(x, out, h, nv, tl, c, c_ptr);
  else
    add_kernel<T, I, kByPtr, false><<<blocks, kBlock, 0, st>>>(x, out, h, nv, tl, c, c_ptr);
}

template <typename T>
int launch(const void* x, void* out, int64_t head, int64_t n_vec, int64_t tail, int64_t blocks,
           int wide, T c, const void* c_ptr, void* stream) {
  if (blocks == 0) return 0;
  if (head > 3 || tail > 3 || blocks > 0x7fffffff || blocks * kBlock < n_vec)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xt = static_cast<const T*>(x);
  auto* ot = static_cast<T*>(out);
  const auto* cp = static_cast<const T*>(c_ptr);
  if (n_vec > 0 && (reinterpret_cast<uintptr_t>(xt + head) % 16 != 0
                    || reinterpret_cast<uintptr_t>(ot + head) % 16 != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto nb = static_cast<unsigned>(blocks);
  if (wide) {
    if (cp) launch_typed<T, int64_t, true>(xt, ot, head, n_vec, tail, nb, c, cp, st);
    else launch_typed<T, int64_t, false>(xt, ot, head, n_vec, tail, nb, c, cp, st);
  } else {
    if (cp) launch_typed<T, uint32_t, true>(xt, ot, head, n_vec, tail, nb, c, cp, st);
    else launch_typed<T, uint32_t, false>(xt, ot, head, n_vec, tail, nb, c, cp, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out f32[n] = x + (c_ptr ? *c_ptr : c), n = head + 4 * n_vec + tail, as
// planned by the host: `blocks` blocks of 256 threads, one vector a thread;
// 64-bit offsets if `wide`. Returns a cudaError_t.
extern "C" int ot_add_scalar_f32(const void* x, void* out, int64_t head, int64_t n_vec,
                                 int64_t tail, int64_t blocks, int wide, float c,
                                 const void* c_ptr, void* stream) {
  return launch<float>(x, out, head, n_vec, tail, blocks, wide, c, c_ptr, stream);
}

// out u32[n] = x + (c_ptr ? *c_ptr : c), modulo 2^32; arguments as above.
extern "C" int ot_add_scalar_u32(const void* x, void* out, int64_t head, int64_t n_vec,
                                 int64_t tail, int64_t blocks, int wide, uint32_t c,
                                 const void* c_ptr, void* stream) {
  return launch<uint32_t>(x, out, head, n_vec, tail, blocks, wide, c, c_ptr, stream);
}
