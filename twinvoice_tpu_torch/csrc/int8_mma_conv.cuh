// The int8 tensor-core pieces shared by K4a/K5 and K7b (int8_window_conv.cuh)
// and K6 (csrc/qupsample2x2.cu): one mma.sync m16n8k32 s8 x s8 -> s32 and the
// ldmatrix loads that feed it from shared memory.
//
// Fragments of mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, with
// g = lane / 4 and q = lane % 4:
//   A (16 x 32 bytes, rows = pixels): a0 row g, k 4q..4q+3; a1 row g + 8, k
//     4q..; a2 row g, k 16+4q..; a3 row g + 8, k 16+4q..
//   B (32 x 8, columns = output channels): b0 k 4q..4q+3 of column g; b1 k
//     16+4q.. of column g
//   D: d0, d1 row g, columns 2q, 2q+1; d2, d3 row g + 8, the same columns.
// ldmatrix.m8n8.b16 hands lane l the four bytes 4q..4q+3 of row g of each
// 8 x 16-byte matrix, so an A fragment is one ldmatrix.x4 whose lanes 0-7,
// 8-15, 16-31 point at the rows of (pixels 0-7, k 0-15), (pixels 8-15,
// k 0-15), (pixels 0-7, k 16-31), (pixels 8-15, k 16-31), and two B
// fragments are one ldmatrix.x4 over output-channel rows of the weights.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace twv {

__device__ __forceinline__ void mma_s8(int* d, const int* a, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 16-byte matrices; lane l gives the address of row l % 8 of matrix
// l / 8 (16-byte aligned).
__device__ __forceinline__ void ldsm_x4(int* r, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Two matrices; lanes 0-15 give the addresses.
__device__ __forceinline__ void ldsm_x2(int* r, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// B fragments of n tiles j and j + 1 (or j alone when NT == 1) at k byte kb of
// weight rows of wb bytes in shared memory at wsm, one row an output column:
// b[0], b[1] for tile j, b[2], b[3] for tile j + 1.
template <int NT>
__device__ __forceinline__ void load_b(int* b, unsigned wsm, int wb, int j, int kb, int lane) {
  const int row = j * 8 + (NT == 1 ? 0 : (lane >> 4) * 8) + (lane & 7);
  const unsigned addr = wsm + row * wb + kb + 16 * ((lane >> 3) & 1);
  if (NT == 1) {
    ldsm_x2(b, addr);
  } else {
    ldsm_x4(b, addr);
  }
}

}  // namespace twv
