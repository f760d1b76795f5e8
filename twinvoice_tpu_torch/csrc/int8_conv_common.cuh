// Pieces shared by the int8 3x3 convolutions K3a, K3b, K4b and K7a: cp.async
// copies into shared memory, the shared-memory pixel stride, word loads that
// zero what lies past the channels, and the requantising epilogue.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace twv {

// Bytes of one pixel's channels in shared memory: c rounded up to 16 bytes,
// then to an odd number of 16-byte granules. Eight threads reading the
// neighbouring pixels' granule k at once (one phase of a 16-byte load) then hit
// eight different bank groups, and a warp reading one 32-bit word of 32
// neighbouring pixels (stride = 4 x odd words) hits 32 different banks in
// groups of eight.
__host__ __device__ constexpr int pixel_bytes(int c) {
  return ((c + 15) / 16) % 2 ? (c + 15) / 16 * 16 : (c + 15) / 16 * 16 + 16;
}

// 16 bytes from global to shared memory, bypassing L1; src_bytes < 16 fills
// the rest with zeros (0: all zeros, nothing is read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Channels c..c+3 of the pixel at p as one little-endian word, zero past C.
__device__ __forceinline__ int load_word(const int8_t* p, int c, int C) {
  unsigned v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (c + j < C) v |= static_cast<unsigned>(static_cast<uint8_t>(p[c + j])) << (8 * j);
  }
  return static_cast<int>(v);
}

// One output of the product epilogue: y = fma(acc, a, b), rounded once as XLA
// rounds JAX's acc * a + b under jit (__fmaf_rn), then ReLU when asked and
// q = rint(y * inv) clipped to [0, 127] after a ReLU and to [-127, 127]
// without one (round half to even, as jnp.round).
__device__ __forceinline__ unsigned requant_fma(int acc, float a, float b, float inv,
                                                bool relu) {
  float y = __fmaf_rn(__int2float_rn(acc), a, b);
  if (relu) y = fmaxf(y, 0.0f);
  const float r = fminf(fmaxf(rintf(__fmul_rn(y, inv)), relu ? 0.0f : -127.0f), 127.0f);
  return static_cast<unsigned>(static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(r))));
}

__host__ __device__ inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace twv
