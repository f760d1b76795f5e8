// K4b on Hopper: int8 3x3 SAME convolution on the int8 tensor cores with an
// s32 sum, then the dequantise -> bias -> (ReLU) -> requantise epilogue, int8
// in and int8 out; Cin <= 128.
//
// Replaces twinvoice_tpu/ops/qconv_pallas.py:qconv3x3_requant_dma, K4a's
// Pallas kernel with hand-pipelined input DMAs: the input stays in HBM and the
// kernel streams halo windows into a two-slot VMEM scratch, starting tile
// t + 1's copy before it computes tile t, with one Cin chunk (Cin <= 128).
//
// Contract: K4a's product mode on NHWC (csrc/qconv3x3.cu), with the dequant
// factor a = s_in * w_scale given per output channel as JAX's kernel takes it:
//   acc[n,h,w,o] = sum_{dy,dx<3, c<Cin} x[n, h+dy-1, w+dx-1, c] * wt[o,dy,dx,c]
// (pixels outside the image read zero), y = fma(acc, a[o], bias[o]) (one
// rounding, as XLA fuses JAX's y = acc * a; y = y + b), then ReLU when asked
// and q = rint(y * inv) clipped to [0, 127] after a ReLU and to [-127, 127]
// without one. JAX's mxu_bf16 mode sums in float32, which is exact only while
// every partial sum stays under 2^24 (127 * 127 * 9 * Cin < 2^24 holds for
// Cin <= 115); here the sum is s32 on the tensor cores, exact at any Cin, so
// the mode changes nothing.
//
// Bound: at the reference's flagship shape (the w64 model's enc0 conv2, b128,
// 512^2, 64 -> 64) the call reads 2.148 GB and writes 2.147 GB, 1.28 ms at
// 3.35 TB/s, against 2.47 T int8 operations, 1.25 ms at 1,979 TOP/s: bound by
// bytes, with the operations close behind, so the multiply-adds have to run
// on the tensor cores for the bytes to be the limit at all.
//
// Design: an implicit GEMM, M = output pixels, N = output channels, K = the 9
// taps times the channels padded with zeros to a multiple of 32, on
// mma.sync.aligned.m16n8k32 (s8 x s8 -> s32; an s32 sum is exact, so the
// result is bit-equal to K4a's). A block owns 8 * NT output channels and walks
// 8 x 32 output tiles (a persistent grid, as many blocks as fit on the card);
// each tile's (8 + 2) x (32 + 2) halo slab streams through a two-slot
// cp.async ring in shared memory, so tile t + 1 lands while the tensor cores
// work on tile t, the zero SAME padding written into the slot. The block's
// weights sit in shared memory for its whole life. Each of the 8 warps takes
// one output row of the tile: two 16-pixel m tiles by NT 8-channel n tiles.
// An A fragment register is one 32-bit word of four channels of one pixel
// (NHWC puts k along the channels), a B fragment register four channels of
// one output channel's weights; pixels sit at a stride of 4 x odd words and
// output channels too, so the 32 lanes' words fall in 32 different banks.
// The int8 results go through shared memory and out as one write a pixel.
//
// C interface for ctypes: twv_qconv3x3_requant_dma launches on the given
// stream and returns cudaGetLastError() as an int (0 = launched).

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "int8_conv_common.cuh"
#include "int8_mma_conv.cuh"

namespace {

constexpr int kTH = 8;   // output rows of a tile, one a warp
constexpr int kTW = 32;  // output columns of a tile, two m tiles of 16
constexpr int kThreads = kTH * 32;
constexpr int kPW = kTW + 2;
constexpr int kPix = (kTH + 2) * kPW;  // pixels of a halo slab
constexpr int kMaxCin = 128;

struct Args {
  const int8_t* x;  // (N, H, W, Cin) int8 contiguous
  const int8_t* w;  // (CoP, 9, Cp) int8, zero past Cin and Co
  const float* a;
  const float* bias;
  int N, H, W, Cin, Co, Cp, CoP;
  int n_th, n_tw, tiles;
  float inv;
  int relu;
  bool vec_in, vec_out;
  int8_t* out;  // (N, H, W, Co) int8 contiguous
};

// The halo slab of tile t (input rows h0-1..h0+8, columns w0-1..w0+32, the
// channels up to Cp) into dst, zeros outside the image and past Cin.
__device__ void stage_slab(const Args& p, uint8_t* dst, int t, int sa) {
  const int n = t / (p.n_th * p.n_tw);
  const int r = t % (p.n_th * p.n_tw);
  const int h0 = r / p.n_tw * kTH - 1;
  const int w0 = r % p.n_tw * kTW - 1;
  const int8_t* img = p.x + static_cast<long long>(n) * p.H * p.W * p.Cin;
  if (p.vec_in) {
    const int g16 = p.Cp / 16;
    for (int i = threadIdx.x; i < kPix * g16; i += kThreads) {
      const int px = i / g16;
      const int k = i - px * g16;
      const int h = h0 + px / kPW;
      const int wc = w0 + px % kPW;
      const bool ok = h >= 0 && h < p.H && wc >= 0 && wc < p.W && 16 * k < p.Cin;
      const int8_t* src = ok ? img + (static_cast<long long>(h) * p.W + wc) * p.Cin + 16 * k : p.x;
      twv::cp_async16(dst + px * sa + 16 * k, src, ok ? 16 : 0);
    }
  } else {
    const int words = p.Cp / 4;
    for (int i = threadIdx.x; i < kPix * words; i += kThreads) {
      const int px = i / words;
      const int q = i - px * words;
      const int h = h0 + px / kPW;
      const int wc = w0 + px % kPW;
      int v = 0;
      if (h >= 0 && h < p.H && wc >= 0 && wc < p.W) {
        v = twv::load_word(img + (static_cast<long long>(h) * p.W + wc) * p.Cin, 4 * q, p.Cin);
      }
      *reinterpret_cast<int*>(dst + px * sa + 4 * q) = v;
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads) qconv3x3_requant_dma_kernel(Args p) {
  constexpr int kCoT = 8 * NT;
  extern __shared__ __align__(16) uint8_t smem[];
  const int sa = p.Cp + 16;      // bytes a slab pixel: 4 x odd words
  const int swb = 9 * p.Cp + 16;  // bytes an output channel's weights: 4 x odd words
  uint8_t* slab = smem;
  uint8_t* wsm = smem + 2 * kPix * sa;
  uint8_t* osm = wsm + kCoT * swb;  // the tile's int8 outputs, [pixel][co]
  const int co0 = blockIdx.y * kCoT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;

  // the block's weights, then the first tile's slab: one cp.async group
  {
    const int g16 = 9 * p.Cp / 16;
    const int8_t* src = p.w + static_cast<long long>(co0) * 9 * p.Cp;
    for (int i = threadIdx.x; i < kCoT * g16; i += kThreads) {
      const int co = i / g16;
      const int k = i - co * g16;
      twv::cp_async16(wsm + co * swb + 16 * k, src + (static_cast<long long>(co) * g16 + k) * 16,
                      16);
    }
  }
  float af[NT][2], bf[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co0 + nt * 8 + 2 * tq + e;
      af[nt][e] = co < p.Co ? p.a[co] : 0.0f;
      bf[nt][e] = co < p.Co ? p.bias[co] : 0.0f;
    }
  }
  if (blockIdx.x < p.tiles) stage_slab(p, slab, blockIdx.x, sa);
  twv::cp_async_commit();

  int it = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++it) {
    const int tn = t + gridDim.x;
    if (tn < p.tiles) stage_slab(p, slab + ((it + 1) & 1) * kPix * sa, tn, sa);
    twv::cp_async_commit();
    twv::cp_async_wait<1>();  // tile t's slab (and the weights) have landed
    __syncthreads();

    const uint8_t* s = slab + (it & 1) * kPix * sa;
    int acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
      }
    }
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
      for (int k0 = 0; k0 < p.Cp; k0 += 32) {
        int af8[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint8_t* p0 = s + ((warp + dy) * kPW + mt * 16 + g + dx) * sa + k0 + 4 * tq;
          const uint8_t* p1 = p0 + 8 * sa;
          af8[mt][0] = *reinterpret_cast<const int*>(p0);
          af8[mt][1] = *reinterpret_cast<const int*>(p1);
          af8[mt][2] = *reinterpret_cast<const int*>(p0 + 16);
          af8[mt][3] = *reinterpret_cast<const int*>(p1 + 16);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint8_t* q = wsm + (nt * 8 + g) * swb + tap * p.Cp + k0 + 4 * tq;
          const int b0 = *reinterpret_cast<const int*>(q);
          const int b1 = *reinterpret_cast<const int*>(q + 16);
          twv::mma_s8(acc[0][nt], af8[0], b0, b1);
          twv::mma_s8(acc[1][nt], af8[1], b0, b1);
        }
      }
    }

    // d0, d1: pixel g, channels 2tq and 2tq+1 of the n tile; d2, d3: pixel g + 8
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int px = warp * kTW + mt * 16 + g + (i >= 2 ? 8 : 0);
          const int co = nt * 8 + 2 * tq + (i & 1);
          osm[px * kCoT + co] = static_cast<uint8_t>(
              twv::requant_fma(acc[mt][nt][i], af[nt][i & 1], bf[nt][i & 1], p.inv, p.relu));
        }
      }
    }
    __syncthreads();

    const int n = t / (p.n_th * p.n_tw);
    const int r = t % (p.n_th * p.n_tw);
    const int h = r / p.n_tw * kTH + threadIdx.x / kTW;
    const int wc = r % p.n_tw * kTW + threadIdx.x % kTW;
    if (h < p.H && wc < p.W) {
      const uint8_t* src = osm + threadIdx.x * kCoT;
      int8_t* o = p.out + ((static_cast<long long>(n) * p.H + h) * p.W + wc) * p.Co + co0;
      if (p.vec_out) {
#pragma unroll
        for (int k = 0; k < kCoT / 16; ++k) {
          reinterpret_cast<int4*>(o)[k] = reinterpret_cast<const int4*>(src)[k];
        }
      } else {
        for (int j = 0; j < kCoT && co0 + j < p.Co; ++j) o[j] = static_cast<int8_t>(src[j]);
      }
    }
  }
  twv::cp_async_wait<0>();
}

template <int NT>
int launch(Args p, cudaStream_t stream) {
  constexpr int kCoT = 8 * NT;
  const size_t smem = 2ull * kPix * (p.Cp + 16) + static_cast<size_t>(kCoT) * (9 * p.Cp + 16) +
                      static_cast<size_t>(kThreads) * kCoT;
  if (p.CoP % kCoT) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(qconv3x3_requant_dma_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, qconv3x3_requant_dma_kernel<NT>, kThreads, smem)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  const int n_co = p.CoP / kCoT;
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(std::min<long long>(p.tiles, (fit + n_co - 1) / n_co));
  p.vec_out = p.vec_out && kCoT % 16 == 0 && p.Co % kCoT == 0;
  qconv3x3_requant_dma_kernel<NT>
      <<<dim3(blocks, n_co), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (N, H, W, Cin) int8 NHWC-contiguous, Cin <= 128; w: (CoP, 9, Cp) int8
// contiguous, Cp = Cin rounded up to 32, CoP = Co rounded up to the block's
// channel tile (8 for Co <= 8, 16 for Co <= 16, 32 for Co <= 32, else 64),
// zero past Cin and Co; a, bias: (Co,) float32; out: (N, H, W, Co) int8
// contiguous; all on the device. out_inv = float32(127) / float32(out_scale);
// relu != 0 applies a ReLU.
extern "C" int twv_qconv3x3_requant_dma(const void* x, const void* w, const void* a,
                                        const void* bias, int N, int H, int W, int Cin,
                                        int Co, int Cp, int CoP, float out_inv, int relu,
                                        void* out, void* stream) {
  const int nt = Co <= 8 ? 1 : Co <= 16 ? 2 : Co <= 32 ? 4 : 8;
  const long long tiles = static_cast<long long>(N) * ((H + kTH - 1) / kTH) *
                          ((W + kTW - 1) / kTW);
  if (N < 1 || H < 1 || W < 1 || Cin < 1 || Cin > kMaxCin || Co < 1 ||
      Cp != (Cin + 31) / 32 * 32 || CoP < Co || CoP / (8 * nt) > 65535 ||
      tiles > 0x7fffffff || !twv::aligned(w, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.a = static_cast<const float*>(a);
  p.bias = static_cast<const float*>(bias);
  p.N = N;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Co = Co;
  p.Cp = Cp;
  p.CoP = CoP;
  p.n_th = (H + kTH - 1) / kTH;
  p.n_tw = (W + kTW - 1) / kTW;
  p.tiles = static_cast<int>(tiles);
  p.inv = out_inv;
  p.relu = relu;
  p.vec_in = Cin % 16 == 0 && twv::aligned(x, 16);
  p.vec_out = twv::aligned(out, 16);
  p.out = static_cast<int8_t*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 1: return launch<1>(p, st);
    case 2: return launch<2>(p, st);
    case 4: return launch<4>(p, st);
    default: return launch<8>(p, st);
  }
}
