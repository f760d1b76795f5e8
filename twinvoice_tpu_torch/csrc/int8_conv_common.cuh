// Pieces shared by the int8 convolutions: cp.async copies into shared memory
// and the wait on a ring of them, the shared-memory pixel stride, word loads
// that zero what lies past the channels, and the requantising epilogues'
// saturating int8 pack.
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

// Waits until at most stages - 1 of this thread's cp.async groups are in
// flight (stages 2 to 4): of the items i .. i + stages - 1 in flight, item i
// has landed.
__device__ __forceinline__ void wait_oldest(int stages) {
  if (stages == 2) {
    cp_async_wait<1>();
  } else if (stages == 3) {
    cp_async_wait<2>();
  } else {
    cp_async_wait<3>();
  }
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

// lo and hi saturated to int8 and packed into the low 16 bits (lo in bits
// 0-7), one cvt.pack.sat a pair.
__device__ __forceinline__ unsigned pack2_s8(int lo, int hi) {
  unsigned d;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(hi), "r"(lo), "r"(0));
  return d;
}

__host__ __device__ inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace twv
