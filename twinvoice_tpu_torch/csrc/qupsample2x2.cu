// K6 on Hopper: int8 2x2 stride-2 transpose convolution with an s32 sum, then
// dequantise -> bias -> symmetric requantise (no ReLU), int8 in and int8 out.
//
// Replaces twinvoice_tpu/ops/qconv_pallas.py:qupsample2x2_requant. Same
// contract: the taps do not overlap, so each output pixel is one Cin-long dot
//   y[n, 2h+dy, 2w+dx, co] = sum_ci K[co, dy, dx, ci] * x[n, h, w, ci]
// (the orientation of pack_wup: quant._conv_transpose2x2_i8's explicit flip
// cancels conv_transpose's own rotation), then, with the multiply and the
// bias add fused into one rounding (__fmaf_rn) as XLA fuses them under jit and
// every other step one correctly rounded float32 operation,
//   q = clip(rint(fma(acc, s0 * w_scale[co], bias[co]) * inv), -127, 127).
// Activations are NHWC-contiguous int8, the weight is (Co, 2, 2, Cin) int8.
//
// Bound: at w16, b128 the level-0 upsample reads 268 MB (128 x 256^2 x 32) and
// writes 537 MB (128 x 512^2 x 16): 0.24 ms at 3.35 TB/s against 69 GOP, so
// it is bound by bytes.
//
// Design: a block takes 256 consecutive input pixels (one per thread) and 16
// output channels; a thread keeps the 4 x 16 s32 sums of its pixel's four
// output pixels in registers and walks Cin four channels (one word, __dp4a) at
// a time, reading the word once for all four taps. The block's weights sit in
// shared memory as [tap][word][co], Cin padded with zeros to a multiple of
// four, and every thread reads the same weight word at once (a broadcast).
// Each output pixel's 16 channels go out as one 16-byte store when Co is a
// multiple of 16.
//
// C interface for ctypes: twv_qupsample2x2_requant launches on the given
// stream and returns cudaGetLastError() as an int (0 = launched).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCoT = 16;  // output channels per block

__device__ __forceinline__ int load_word(const int8_t* p, int c, int Cin, bool vec4) {
  if (vec4) return *reinterpret_cast<const int*>(p + c);
  unsigned v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (c + j < Cin) v |= static_cast<unsigned>(static_cast<uint8_t>(p[c + j])) << (8 * j);
  }
  return static_cast<int>(v);
}

__global__ void __launch_bounds__(kThreads)
qupsample2x2_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ w_scale, const float* __restrict__ bias,
                    long long pixels, int H, int W, int Cin, int Co, float s0,
                    float inv, bool vec4, bool vec_out, int8_t* __restrict__ out) {
  extern __shared__ int wt[];  // [4 taps][words][kCoT]
  const int words = (Cin + 3) / 4;
  const int co0 = blockIdx.y * kCoT;
  for (int i = threadIdx.x; i < 4 * words * kCoT; i += kThreads) {
    const int j = i % kCoT;
    const int t = i / kCoT;
    const int q = t % words;
    const int tap = t / words;
    const int co = co0 + j;
    wt[i] = co < Co ? load_word(w + (static_cast<long long>(co) * 4 + tap) * Cin, 4 * q, Cin, vec4)
                    : 0;
  }
  __syncthreads();

  const long long pix = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (pix >= pixels) return;
  const int8_t* px = x + pix * Cin;
  int acc[4][kCoT];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int j = 0; j < kCoT; ++j) acc[t][j] = 0;
  }
  for (int q = 0; q < words; ++q) {
    const int xv = load_word(px, 4 * q, Cin, vec4);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int* wr = wt + (t * words + q) * kCoT;
#pragma unroll
      for (int j = 0; j < kCoT; ++j) acc[t][j] = __dp4a(xv, wr[j], acc[t][j]);
    }
  }

  const long long hw = static_cast<long long>(H) * W;
  const long long n = pix / hw;
  const int h = static_cast<int>((pix % hw) / W);
  const int wc = static_cast<int>(pix % W);
  float a[kCoT];
  float b[kCoT];
#pragma unroll
  for (int j = 0; j < kCoT; ++j) {
    const int co = co0 + j;
    a[j] = co < Co ? __fmul_rn(s0, w_scale[co]) : 0.0f;
    b[j] = co < Co ? bias[co] : 0.0f;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    unsigned packed[kCoT / 4] = {};
#pragma unroll
    for (int j = 0; j < kCoT; ++j) {
      const float y = __fmaf_rn(__int2float_rn(acc[t][j]), a[j], b[j]);
      const float r = fminf(fmaxf(rintf(__fmul_rn(y, inv)), -127.0f), 127.0f);
      packed[j / 4] |= static_cast<unsigned>(static_cast<uint8_t>(__float2int_rn(r)))
                       << (8 * (j % 4));
    }
    const int oh = 2 * h + t / 2;
    const int ow = 2 * wc + t % 2;
    int8_t* o = out + ((n * 2 * H + oh) * 2LL * W + ow) * Co + co0;
    if (vec_out) {
      *reinterpret_cast<int4*>(o) = make_int4(packed[0], packed[1], packed[2], packed[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kCoT; ++j) {
        if (co0 + j < Co) o[j] = static_cast<int8_t>(packed[j / 4] >> (8 * (j % 4)));
      }
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// x: (N, H, W, Cin) int8 NHWC-contiguous; w: (Co, 2, 2, Cin) int8 contiguous;
// w_scale, bias: (Co,) float32; out: (N, 2H, 2W, Co) int8 contiguous; all on
// the device. s0 and out_inv are the epilogue's scalars (see the note above).
extern "C" int twv_qupsample2x2_requant(const void* x, const void* w,
                                        const void* w_scale, const void* bias,
                                        int N, int H, int W, int Cin, int Co,
                                        float s0, float out_inv, void* out,
                                        void* stream) {
  const long long pixels = static_cast<long long>(N) * H * W;
  const int n_co = (Co + kCoT - 1) / kCoT;
  const size_t smem = sizeof(int) * 4 * ((Cin + 3) / 4) * kCoT;
  if (N < 1 || H < 1 || W < 1 || Cin < 1 || Co < 1 || n_co > 65535 ||
      smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        qupsample2x2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool vec4 = Cin % 4 == 0 && aligned(x, 4) && aligned(w, 4);
  const bool vec_out = Co % kCoT == 0 && aligned(out, 16);
  const dim3 grid(static_cast<unsigned>((pixels + kThreads - 1) / kThreads), n_co);
  qupsample2x2_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias), pixels, H,
      W, Cin, Co, s0, out_inv, vec4, vec_out, static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
