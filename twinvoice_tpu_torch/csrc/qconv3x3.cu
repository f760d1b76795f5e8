// K4a and K5 on Hopper: int8 3x3 SAME convolution with an s32 sum, then the
// dequantise -> bias -> (ReLU) -> requantise epilogue, int8 in and int8 out.
//
// Replaces twinvoice_tpu/ops/qconv_pallas.py:qconv3x3_requant (K4a) and
// :qconv3x3_split_requant (K5), which share one Pallas kernel factory
// (`_make_qconv_kernel`); here they share one kernel template. K5 takes a
// second input and a second weight (the decoder's upsample and skip halves)
// whose products go into a second s32 sum, so one kernel also computes the
// split XLA form of quant.py:242, where the two halves keep their own scales.
//
// Layout: activations are NHWC-contiguous int8 (channels innermost, the layout
// dp4a and the int8 tensor cores take along k); weights are (Co, 3, 3, Cin)
// int8. SAME padding is done by bounds checks while a tile is staged: the
// TPU's zero-bordered (H+8, C, W+64, N) frame is not carried over.
//
// Epilogue, with acc the s32 sum, w = w_scale[co] and b = bias[co], in the
// association of the JAX call site and rounded where JAX rounds: under jit,
// XLA fuses a multiply and the add that consumes it into one fused
// multiply-add (FMA, __fmaf_rn, one rounding), and every other step is one
// correctly rounded float32 operation (__fmul_rn, __fadd_rn):
//   kProd     fma(acc, s0 * w, b)                  quant._qconv, the Pallas kernels
//   kChain    fma(acc * s0, w, b)                  the concat decoder, quant.py:237
//   kSeparate fma(fma(acc1, s0, acc2 * s1), w, b)  the split decoder, quant.py:242
// (tests/test_torch_epilogue.py finds each form in JAX at searched ties), then
// ReLU when asked, q = rint(y * inv) clipped to [0, 127] after a ReLU and to
// [-127, 127] without one (round half to even, as jnp.round).
//
// Bound: at w16, b128, 512^2 the level-0 16->16 conv reads 537 MB and writes
// 537 MB (0.32 ms at 3.35 TB/s) for 155 GOP (0.08 ms at 1,979 TOP/s int8 on
// the tensor cores), so on the card it is bound by bytes. This first kernel
// runs on the CUDA cores (__dp4a: four int8 products and an s32 add per
// instruction), which puts its own ceiling on the operations well above the
// byte bound; the tensor-core version (mma.sync m16n8k32 s8, or wgmma) and a
// cp.async/TMA ring are later work.
//
// Design: a block computes an 8 x 32 tile of output pixels of one image for 16
// output channels, one pixel per thread with 16 s32 sums in registers. Cin is
// walked in chunks of 4*Q channels (Q words of four int8 each, Q in 1, 2, 4,
// 8 chosen from Cin): the (8+2) x (32+2) halo tile of the chunk and the
// chunk's weights are staged in shared memory, channels past Cin and pixels
// outside the image as zeros, so any Cin works and the caller pads nothing. A
// pixel's words sit at an odd stride in shared memory, so the 32 threads of a
// warp (32 neighbouring pixels) read 32 different banks; every thread reads
// the same weight word at once (a broadcast).
//
// C interface for ctypes: twv_qconv3x3_requant launches on the given stream
// and returns cudaGetLastError() as an int (0 = launched).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTH = 8;
constexpr int kTW = 32;
constexpr int kThreads = kTH * kTW;
constexpr int kCoT = 16;  // output channels per block
constexpr int kTileW = kTW + 2;
constexpr int kTilePix = (kTH + 2) * kTileW;

enum Mode { kProd = 0, kChain = 1, kSeparate = 2 };

struct Epilogue {
  float s0, s1, inv;
  int mode, relu;
};

// Words of a pixel in shared memory: Q rounded up to an odd number.
template <int Q>
__host__ __device__ constexpr int pixel_stride() {
  return Q % 2 ? Q : Q + 1;
}

// Channels c..c+3 of the pixel at p as one word, zero past Cin.
__device__ __forceinline__ int load_word(const int8_t* p, int c, int Cin, bool vec4) {
  if (vec4) return c < Cin ? *reinterpret_cast<const int*>(p + c) : 0;
  unsigned v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (c + j < Cin) v |= static_cast<unsigned>(static_cast<uint8_t>(p[c + j])) << (8 * j);
  }
  return static_cast<int>(v);
}

template <int Q>
__device__ void stage_tile(int* dst, const int8_t* __restrict__ x, int n, int h0,
                           int w0, int H, int W, int Cin, int c0, bool vec4) {
  constexpr int PS = pixel_stride<Q>();
  for (int i = threadIdx.x; i < kTilePix * Q; i += kThreads) {
    const int p = i / Q;
    const int q = i - p * Q;
    const int gh = h0 + p / kTileW - 1;
    const int gw = w0 + p % kTileW - 1;
    int v = 0;
    if (gh >= 0 && gh < H && gw >= 0 && gw < W) {
      const int8_t* px = x + ((static_cast<long long>(n) * H + gh) * W + gw) * Cin;
      v = load_word(px, c0 + 4 * q, Cin, vec4);
    }
    dst[p * PS + q] = v;
  }
}

// Weights of the chunk as [tap][q][co], co fastest.
template <int Q>
__device__ void stage_weights(int* dst, const int8_t* __restrict__ w, int co0, int Co,
                              int Cin, int c0, bool vec4) {
  for (int i = threadIdx.x; i < 9 * Q * kCoT; i += kThreads) {
    const int j = i % kCoT;
    const int t = i / kCoT;
    const int q = t % Q;
    const int tap = t / Q;
    const int co = co0 + j;
    dst[i] = co < Co
        ? load_word(w + (static_cast<long long>(co) * 9 + tap) * Cin, c0 + 4 * q, Cin, vec4)
        : 0;
  }
}

template <int Q>
__device__ __forceinline__ void accumulate(int* acc, const int* tile, const int* wt,
                                           int ty, int tx) {
  constexpr int PS = pixel_stride<Q>();
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int p = (ty + tap / 3) * kTileW + tx + tap % 3;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int xv = tile[p * PS + q];
      const int* wr = wt + (tap * Q + q) * kCoT;
#pragma unroll
      for (int j = 0; j < kCoT; ++j) acc[j] = __dp4a(xv, wr[j], acc[j]);
    }
  }
}

template <int Q, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
qconv3x3_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ x2,
                const int8_t* __restrict__ w, const int8_t* __restrict__ w2,
                const float* __restrict__ w_scale, const float* __restrict__ bias,
                int H, int W, int Cin, int Co, int n_co, Epilogue ep, bool vec4,
                bool vec_out, int8_t* __restrict__ out) {
  constexpr int PS = pixel_stride<Q>();
  __shared__ int tile[SPLIT ? 2 : 1][kTilePix * PS];
  __shared__ __align__(16) int wt[SPLIT ? 2 : 1][9 * Q * kCoT];

  const int n = blockIdx.z / n_co;
  const int co0 = (blockIdx.z % n_co) * kCoT;
  const int h0 = blockIdx.y * kTH;
  const int w0 = blockIdx.x * kTW;
  const int ty = threadIdx.x / kTW;
  const int tx = threadIdx.x % kTW;

  int acc[kCoT];
  int acc2[kCoT];
#pragma unroll
  for (int j = 0; j < kCoT; ++j) acc[j] = acc2[j] = 0;

  for (int c0 = 0; c0 < Cin; c0 += 4 * Q) {
    stage_tile<Q>(tile[0], x, n, h0, w0, H, W, Cin, c0, vec4);
    stage_weights<Q>(wt[0], w, co0, Co, Cin, c0, vec4);
    if (SPLIT) {
      stage_tile<Q>(tile[SPLIT ? 1 : 0], x2, n, h0, w0, H, W, Cin, c0, vec4);
      stage_weights<Q>(wt[SPLIT ? 1 : 0], w2, co0, Co, Cin, c0, vec4);
    }
    __syncthreads();
    accumulate<Q>(acc, tile[0], wt[0], ty, tx);
    if (SPLIT) accumulate<Q>(acc2, tile[SPLIT ? 1 : 0], wt[SPLIT ? 1 : 0], ty, tx);
    __syncthreads();
  }

  const int h = h0 + ty;
  const int wc = w0 + tx;
  if (h >= H || wc >= W) return;
  const float lo = ep.relu ? 0.0f : -127.0f;
  unsigned packed[kCoT / 4] = {};
#pragma unroll
  for (int j = 0; j < kCoT; ++j) {
    const int co = co0 + j;
    const float ws = co < Co ? w_scale[co] : 0.0f;
    const float b = co < Co ? bias[co] : 0.0f;
    float y;
    if (SPLIT && ep.mode == kSeparate) {
      const float p2 = __fmul_rn(__int2float_rn(acc2[j]), ep.s1);
      y = __fmaf_rn(__fmaf_rn(__int2float_rn(acc[j]), ep.s0, p2), ws, b);
    } else {
      const float f = __int2float_rn(SPLIT ? acc[j] + acc2[j] : acc[j]);
      y = ep.mode == kChain ? __fmaf_rn(__fmul_rn(f, ep.s0), ws, b)
                            : __fmaf_rn(f, __fmul_rn(ep.s0, ws), b);
    }
    if (ep.relu) y = fmaxf(y, 0.0f);
    const float r = fminf(fmaxf(rintf(__fmul_rn(y, ep.inv)), lo), 127.0f);
    packed[j / 4] |= static_cast<unsigned>(static_cast<uint8_t>(__float2int_rn(r)))
                     << (8 * (j % 4));
  }
  int8_t* o = out + ((static_cast<long long>(n) * H + h) * W + wc) * Co + co0;
  if (vec_out) {
    *reinterpret_cast<int4*>(o) = make_int4(packed[0], packed[1], packed[2], packed[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kCoT; ++j) {
      if (co0 + j < Co) o[j] = static_cast<int8_t>(packed[j / 4] >> (8 * (j % 4)));
    }
  }
}

template <int Q>
void launch(const int8_t* x, const int8_t* x2, const int8_t* w, const int8_t* w2,
            const float* w_scale, const float* bias, int N, int H, int W, int Cin,
            int Co, const Epilogue& ep, bool vec4, bool vec_out, int8_t* out,
            cudaStream_t stream) {
  const int n_co = (Co + kCoT - 1) / kCoT;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, N * n_co);
  if (x2) {
    qconv3x3_kernel<Q, true><<<grid, kThreads, 0, stream>>>(
        x, x2, w, w2, w_scale, bias, H, W, Cin, Co, n_co, ep, vec4, vec_out, out);
  } else {
    qconv3x3_kernel<Q, false><<<grid, kThreads, 0, stream>>>(
        x, x2, w, w2, w_scale, bias, H, W, Cin, Co, n_co, ep, vec4, vec_out, out);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// x: (N, H, W, Cin) int8 NHWC-contiguous; w: (Co, 3, 3, Cin) int8 contiguous;
// x2, w2: the second input and weight of the split form (same shapes), or
// null for one input; w_scale, bias: (Co,) float32; out: (N, H, W, Co) int8
// contiguous; all on the device. s0, s1, out_inv and the mode are the
// epilogue's (see the note above); relu != 0 applies a ReLU.
extern "C" int twv_qconv3x3_requant(const void* x, const void* x2, const void* w,
                                    const void* w2, const void* w_scale,
                                    const void* bias, int N, int H, int W, int Cin,
                                    int Co, float s0, float s1, float out_inv,
                                    int mode, int relu, void* out, void* stream) {
  if (N < 1 || H < 1 || W < 1 || Cin < 1 || Co < 1 || mode < kProd ||
      mode > kSeparate || (mode == kSeparate && !x2) || (!x2 != !w2) ||
      N * ((Co + kCoT - 1) / kCoT) > 65535 || (H + kTH - 1) / kTH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Epilogue ep{s0, s1, out_inv, mode, relu};
  const bool vec4 = Cin % 4 == 0 && aligned(x, 4) && aligned(w, 4) &&
                    (!x2 || (aligned(x2, 4) && aligned(w2, 4)));
  const bool vec_out = Co % kCoT == 0 && aligned(out, 16);
  const auto* xi = static_cast<const int8_t*>(x);
  const auto* x2i = static_cast<const int8_t*>(x2);
  const auto* wi = static_cast<const int8_t*>(w);
  const auto* w2i = static_cast<const int8_t*>(w2);
  const auto* ws = static_cast<const float*>(w_scale);
  const auto* b = static_cast<const float*>(bias);
  auto* o = static_cast<int8_t*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int words = (Cin + 3) / 4;
  if (words == 1) {
    launch<1>(xi, x2i, wi, w2i, ws, b, N, H, W, Cin, Co, ep, vec4, vec_out, o, st);
  } else if (words == 2) {
    launch<2>(xi, x2i, wi, w2i, ws, b, N, H, W, Cin, Co, ep, vec4, vec_out, o, st);
  } else if (words <= 4) {
    launch<4>(xi, x2i, wi, w2i, ws, b, N, H, W, Cin, Co, ep, vec4, vec_out, o, st);
  } else {
    launch<8>(xi, x2i, wi, w2i, ws, b, N, H, W, Cin, Co, ep, vec4, vec_out, o, st);
  }
  return static_cast<int>(cudaGetLastError());
}
