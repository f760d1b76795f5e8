// The slab ring shared by K3a (csrc/qconv3x3_nhwc_dma.cu) and K7a
// (csrc/qconv3x3_pair_dma.cu), the Hopper counterparts of the JAX package's
// two manual-DMA Pallas kernels: a block owns one image and 16 output
// channels and walks every 8 x 32 output tile of that image in order,
// streaming each tile's input slab (8 + 2 rows by 32 + kTapsW - 1 columns,
// kChunk channels at a time) through a two-slot ring in shared memory with
// cp.async: while the block multiplies slab t, slab t + 1 lands.
//
// The two kernels differ only in what their input is and how many column
// taps the convolution has, so each instantiates slab_ring_kernel<kTapsW>
// with its own geometry:
//   input row of slab row i    = h0 + i + row_off  (zero outside [0, Hin))
//   input column of slab col j = w0 + j + col_off  (zero outside [0, Win))
//   acc[n,h,w,o] = sum_{dy<3, dx<kTapsW, c<C} slab[h-h0+dy, w-w0+dx, c] * wt[o,dy,dx,c]
//   y = fma(acc, a[o], bias[o])  (one rounding, as XLA fuses JAX's acc*a + b)
// then ReLU when asked and the requant of int8_conv_common.cuh. With
// zero_pad_pairs, the output is a phase-A pair tensor and the lower half of
// pair 0 and the upper half of the last pair are written as zeros.
//
// A thread computes one output pixel of the tile for the block's 16 output
// channels (16 s32 sums in registers), four channels an instruction on the
// CUDA cores (__dp4a). The weights are read from global memory (L1) as
// [tap][word][co] int32 words, prepacked by the wrapper with the channels
// padded to whole chunks; every thread of a warp reads the same 16 bytes.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "int8_conv_common.cuh"

namespace twv {

constexpr int kSlabTH = 8;   // output rows of a tile
constexpr int kSlabTW = 32;  // output columns of a tile
constexpr int kSlabThreads = kSlabTH * kSlabTW;
constexpr int kSlabCoT = 16;  // output channels of a block

struct SlabArgs {
  const int8_t* x;  // (N, Hin, Win, C) int8 contiguous
  const int4* w;    // [taps][CW][CoP] int32 words, CW = Cpad / 4
  const float* a;
  const float* bias;
  int Hin, Win, C, H, W, Co;  // input dims and channels, output dims and channels
  int chunk, CW, CoP, n_co;   // channels of a ring unit (a multiple of 16)
  int row_off, col_off;
  float inv;
  int relu;
  bool zero_pad_pairs, vec_in, vec_out;
  int8_t* out;  // (N, H, W, Co) int8 contiguous
};

template <int kTapsW>
__device__ void stage_slab(const SlabArgs& p, uint8_t* dst, int n, int h0, int w0, int c0,
                           int pb) {
  constexpr int PW = kSlabTW + kTapsW - 1;
  constexpr int PIX = (kSlabTH + 2) * PW;
  const int8_t* img = p.x + static_cast<long long>(n) * p.Hin * p.Win * p.C;
  if (p.vec_in) {
    const int g16 = pb / 16;
    for (int i = threadIdx.x; i < PIX * g16; i += kSlabThreads) {
      const int px = i / g16;
      const int k = i - px * g16;
      const int hr = h0 + px / PW + p.row_off;
      const int wc = w0 + px % PW + p.col_off;
      const int c = c0 + 16 * k;
      const bool ok = hr >= 0 && hr < p.Hin && wc >= 0 && wc < p.Win && 16 * k < p.chunk &&
                      c < p.C;
      const int8_t* src = ok ? img + (static_cast<long long>(hr) * p.Win + wc) * p.C + c : p.x;
      cp_async16(dst + px * pb + 16 * k, src, ok ? 16 : 0);
    }
  } else {
    const int words = pb / 4;
    for (int i = threadIdx.x; i < PIX * words; i += kSlabThreads) {
      const int px = i / words;
      const int q = i - px * words;
      const int hr = h0 + px / PW + p.row_off;
      const int wc = w0 + px % PW + p.col_off;
      int v = 0;
      if (hr >= 0 && hr < p.Hin && wc >= 0 && wc < p.Win && 4 * q < p.chunk) {
        v = load_word(img + (static_cast<long long>(hr) * p.Win + wc) * p.C, c0 + 4 * q, p.C);
      }
      reinterpret_cast<int*>(dst)[px * words + q] = v;
    }
  }
}

template <int kTapsW>
__global__ void __launch_bounds__(kSlabThreads) slab_ring_kernel(SlabArgs p) {
  constexpr int PW = kSlabTW + kTapsW - 1;
  constexpr int PIX = (kSlabTH + 2) * PW;
  extern __shared__ __align__(16) uint8_t ring[];
  const int pb = pixel_bytes(p.chunk);
  const int slot_bytes = PIX * pb;
  const int n = blockIdx.x;
  const int co0 = blockIdx.y * kSlabCoT;
  const int ty = threadIdx.x / kSlabTW;
  const int tx = threadIdx.x % kSlabTW;
  const int ntw = (p.W + kSlabTW - 1) / kSlabTW;
  const int n_chunk = p.CW * 4 / p.chunk;
  const int units = (p.H + kSlabTH - 1) / kSlabTH * ntw * n_chunk;
  const int wrow = p.CoP / 4;

  float a[kSlabCoT], b[kSlabCoT];
#pragma unroll
  for (int j = 0; j < kSlabCoT; ++j) {
    const int co = co0 + j;
    a[j] = co < p.Co ? p.a[co] : 0.0f;
    b[j] = co < p.Co ? p.bias[co] : 0.0f;
  }

  // unit u: tile u / n_chunk (row-major over the image), chunk u % n_chunk
  stage_slab<kTapsW>(p, ring, n, 0, 0, 0, pb);
  cp_async_commit();
  int acc[kSlabCoT];
  for (int u = 0; u < units; ++u) {
    if (u + 1 < units) {
      const int t1 = (u + 1) / n_chunk;
      stage_slab<kTapsW>(p, ring + ((u + 1) & 1) * slot_bytes, n, t1 / ntw * kSlabTH,
                         t1 % ntw * kSlabTW, (u + 1) % n_chunk * p.chunk, pb);
    }
    cp_async_commit();
    cp_async_wait<1>();  // unit u has landed; u + 1 may be in flight
    __syncthreads();
    const int k_chunk = u % n_chunk;
    if (k_chunk == 0) {
#pragma unroll
      for (int j = 0; j < kSlabCoT; ++j) acc[j] = 0;
    }
    const uint8_t* slab = ring + (u & 1) * slot_bytes;
    const int q16 = p.chunk / 16;
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < kTapsW; ++dx) {
        const int4* xp = reinterpret_cast<const int4*>(slab + ((ty + dy) * PW + tx + dx) * pb);
        const int4* wp = p.w +
                         static_cast<long long>((dy * kTapsW + dx) * p.CW + k_chunk * p.chunk / 4) *
                             wrow +
                         co0 / 4;
        for (int k = 0; k < q16; ++k) {
          const int4 xv = xp[k];
          const int xw[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int4* wq = wp + static_cast<long long>(4 * k + q) * wrow;
            const int4 w0v = __ldg(wq), w1v = __ldg(wq + 1), w2v = __ldg(wq + 2),
                       w3v = __ldg(wq + 3);
            const int wv[kSlabCoT] = {w0v.x, w0v.y, w0v.z, w0v.w, w1v.x, w1v.y, w1v.z, w1v.w,
                                      w2v.x, w2v.y, w2v.z, w2v.w, w3v.x, w3v.y, w3v.z, w3v.w};
#pragma unroll
            for (int j = 0; j < kSlabCoT; ++j) acc[j] = __dp4a(xw[q], wv[j], acc[j]);
          }
        }
      }
    }
    __syncthreads();  // the slot of unit u is free for unit u + 2

    if (k_chunk != n_chunk - 1) continue;
    const int t = u / n_chunk;
    const int h = t / ntw * kSlabTH + ty;
    const int wc = t % ntw * kSlabTW + tx;
    if (h >= p.H || wc >= p.W) continue;
    const int half = p.Co / 2;
    unsigned packed[kSlabCoT / 4] = {};
#pragma unroll
    for (int j = 0; j < kSlabCoT; ++j) {
      const int co = co0 + j;
      unsigned q = requant_fma(acc[j], a[j], b[j], p.inv, p.relu);
      if (p.zero_pad_pairs && ((wc == 0 && co < half) || (wc == p.W - 1 && co >= half))) q = 0;
      packed[j / 4] |= q << (8 * (j % 4));
    }
    int8_t* o = p.out + ((static_cast<long long>(n) * p.H + h) * p.W + wc) * p.Co + co0;
    if (p.vec_out) {
      *reinterpret_cast<int4*>(o) = make_int4(packed[0], packed[1], packed[2], packed[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kSlabCoT; ++j) {
        if (co0 + j < p.Co) o[j] = static_cast<int8_t>(packed[j / 4] >> (8 * (j % 4)));
      }
    }
  }
  cp_async_wait<0>();
}

// Checks the geometry, sets the shared memory and launches; returns a
// cudaError_t as an int (0 = launched).
template <int kTapsW>
int launch_slab_ring(SlabArgs p, int N, cudaStream_t stream) {
  constexpr int PIX = (kSlabTH + 2) * (kSlabTW + kTapsW - 1);
  p.n_co = (p.Co + kSlabCoT - 1) / kSlabCoT;
  const size_t smem = 2ull * PIX * pixel_bytes(p.chunk);
  if (N < 1 || p.H < 1 || p.W < 1 || p.C < 1 || p.Co < 1 || p.chunk < 16 || p.chunk % 16 ||
      p.CW * 4 < p.C || (p.CW * 4) % p.chunk || p.CoP % 64 || p.CoP < p.Co || N > 65535 ||
      p.n_co > 65535 || smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        slab_ring_kernel<kTapsW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  p.vec_in = p.C % 16 == 0 && aligned(p.x, 16);
  p.vec_out = p.Co % kSlabCoT == 0 && aligned(p.out, 16);
  slab_ring_kernel<kTapsW><<<dim3(N, p.n_co), kSlabThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace twv
