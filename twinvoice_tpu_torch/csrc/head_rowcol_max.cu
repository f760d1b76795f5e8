// K2 on Hopper: the int8 serving head. The 1x1 logit conv and both box
// reductions in one pass over the final int8 activations; the logits are never
// written.
//
// Replaces twinvoice_tpu/ops/pallas_head.py:head_rowcol_max (Pallas kernel
// `_head_kernel`). Same contract: with wf = bf16(w * act_scale) (C, 3) and
// x = the int8 activations (exact in bf16), logits = x . wf summed in float32,
// and the outputs are the bias-free maxima
//   row_max[b, h, k] = max_w logits[b, h, w, k]    (B, H, 3) float32
//   col_max[b, w, k] = max_h logits[b, h, w, k]    (B, W, 3) float32.
// The bias is folded into the thresholds by the caller. Every product of an
// int8 and a bf16 is exact in float32, so only the order of the sum over C
// differs from another implementation: it runs in channel order here.
// With bf16_weights = 0, wf = w * act_scale stays float32 (the W-phase heads
// of twinvoice_tpu/infer/wpack.py, a float32 XLA conv): each fmaf then rounds
// a product once with its sum, still within C ulps of any order's sum.
//
// Bound: the activations are read once (128 x 512^2 x 16 = 537 MB at w16,
// b128: 0.16 ms at 3.35 TB/s); 3 x 2 x C operations a pixel are far below the
// card's rate, so it is bound by bytes.
//
// Design: the TPU kernel walks rows in a sequential grid and carries the
// column max across them in one VMEM block (the cross-tile accumulation that
// once read stale tiles on hardware, pallas_head.py:42-47). Blocks here run in
// parallel and in no order, so the column max is reduced in two launches and
// never by racing writes: a block takes a band of rows of one image, each of
// its threads owns whole columns (col, col+256, ...) and keeps their running
// maxima in shared memory, and the band's column maxima go to a partial
// buffer (B, bands, W, 3); a second launch takes the max over the bands. The
// row max of a row is reduced over a warp's columns with shuffles, kept per
// warp in shared memory, and merged over the warps once the band is done.
// Neighbouring threads read neighbouring pixels: one 16-byte load a pixel
// when C is a multiple of 16 (C = 16 at w16).
//
// C interface for ctypes: twv_head_rowcol_max launches on the given stream
// and returns cudaGetLastError() as an int (0 = launched).

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kK = 3;  // classes

__device__ __forceinline__ void dot_word(unsigned v, const float* wc, float* l) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float xv = static_cast<float>(static_cast<int8_t>(v >> (8 * j)));
#pragma unroll
    for (int k = 0; k < kK; ++k) l[k] = fmaf(xv, wc[j * kK + k], l[k]);
  }
}

// Logits of one pixel; VEC = bytes a load: 16 (C % 16 == 0), 4 (C % 4 == 0)
// or 1. The products are exact, so fmaf rounds exactly as a sum would.
template <int VEC>
__device__ __forceinline__ void pixel_logits(const int8_t* px, const float* ws, int C,
                                             float* l) {
  l[0] = l[1] = l[2] = 0.0f;
  if (VEC == 16) {
    for (int c = 0; c < C; c += 16) {
      const int4 v = *reinterpret_cast<const int4*>(px + c);
      dot_word(static_cast<unsigned>(v.x), ws + (c + 0) * kK, l);
      dot_word(static_cast<unsigned>(v.y), ws + (c + 4) * kK, l);
      dot_word(static_cast<unsigned>(v.z), ws + (c + 8) * kK, l);
      dot_word(static_cast<unsigned>(v.w), ws + (c + 12) * kK, l);
    }
  } else if (VEC == 4) {
    for (int c = 0; c < C; c += 4) {
      dot_word(*reinterpret_cast<const unsigned*>(px + c), ws + c * kK, l);
    }
  } else {
    for (int c = 0; c < C; ++c) {
      const float xv = static_cast<float>(px[c]);
#pragma unroll
      for (int k = 0; k < kK; ++k) l[k] = fmaf(xv, ws[c * kK + k], l[k]);
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
head_band_kernel(const int8_t* __restrict__ x, const float* __restrict__ w,
                 float act_scale, int bf16_weights, int H, int W, int C, int rows,
                 float* __restrict__ row_max, float* __restrict__ partial) {
  extern __shared__ float smem[];
  float* ws = smem;                  // (C, 3) scaled weights
  float* col = ws + C * kK;          // (W, 3) running column maxima
  float* rowp = col + W * kK;        // (rows, warps, 3) per-warp row maxima
  const int band = blockIdx.x;
  const int bands = gridDim.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < C * kK; i += kThreads) {
    const float v = __fmul_rn(w[i], act_scale);
    ws[i] = bf16_weights ? __bfloat162float(__float2bfloat16_rn(v)) : v;
  }
  for (int i = threadIdx.x; i < W * kK; i += kThreads) col[i] = -INFINITY;
  __syncthreads();

  const int r0 = band * rows;
  const int r1 = min(H, r0 + rows);
  for (int r = r0; r < r1; ++r) {
    float m[kK] = {-INFINITY, -INFINITY, -INFINITY};
    const int8_t* xr = x + (static_cast<long long>(b) * H + r) * W * C;
    for (int c = threadIdx.x; c < W; c += kThreads) {
      float l[kK];
      pixel_logits<VEC>(xr + static_cast<long long>(c) * C, ws, C, l);
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        m[k] = fmaxf(m[k], l[k]);
        col[c * kK + k] = fmaxf(col[c * kK + k], l[k]);  // column c is this thread's
      }
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m[k] = fmaxf(m[k], __shfl_xor_sync(0xffffffffu, m[k], off));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kK; ++k) rowp[((r - r0) * kWarps + warp) * kK + k] = m[k];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < (r1 - r0) * kK; i += kThreads) {
    const int rl = i / kK;
    const int k = i % kK;
    float m = -INFINITY;
    for (int v = 0; v < kWarps; ++v) m = fmaxf(m, rowp[(rl * kWarps + v) * kK + k]);
    row_max[(static_cast<long long>(b) * H + r0 + rl) * kK + k] = m;
  }
  float* pb = partial + (static_cast<long long>(b) * bands + band) * W * kK;
  for (int i = threadIdx.x; i < W * kK; i += kThreads) pb[i] = col[i];
}

// col_max[b, i] = max over bands of partial[b, band, i], i over W * 3.
__global__ void head_col_reduce_kernel(const float* __restrict__ partial, int bands,
                                       long long per_image, long long total,
                                       float* __restrict__ col_max) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = i / per_image;
    const long long j = i % per_image;
    const float* p = partial + b * bands * per_image + j;
    float m = -INFINITY;
    for (int t = 0; t < bands; ++t) m = fmaxf(m, p[t * per_image]);
    col_max[i] = m;
  }
}

template <int VEC>
cudaError_t launch_band(const int8_t* x, const float* w, float act_scale, int bf16_w,
                        int B, int H, int W, int C, int bands, int rows, size_t smem,
                        float* row_max, float* partial, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        head_band_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  head_band_kernel<VEC><<<dim3(bands, B), kThreads, smem, stream>>>(
      x, w, act_scale, bf16_w, H, W, C, rows, row_max, partial);
  return cudaGetLastError();
}

}  // namespace

// x: (B, H, W, C) int8 NHWC-contiguous; w: (C, 3) float32 contiguous, the
// out-conv weight; act_scale: the activations' dequant scale; bf16_weights !=
// 0 rounds w * act_scale to bf16 (the Pallas head), 0 keeps it float32. Each
// image is cut into `bands` bands of `rows` rows (bands * rows >= H, no band
// empty).
// partial: (B, bands, W, 3) float32 scratch; row_max: (B, H, 3) and col_max:
// (B, W, 3) float32 contiguous; all on the device.
extern "C" int twv_head_rowcol_max(const void* x, const void* w, float act_scale,
                                   int bf16_weights, int B, int H, int W, int C,
                                   int bands, int rows,
                                   void* partial, void* row_max, void* col_max,
                                   void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(C) * kK +
                                       static_cast<size_t>(W) * kK +
                                       static_cast<size_t>(rows) * kWarps * kK);
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || bands < 1 || rows < 1 ||
      (bands - 1) * rows >= H || bands * rows < H || smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const int8_t*>(x);
  const auto* wf = static_cast<const float*>(w);
  auto* pt = static_cast<float*>(partial);
  auto* rm = static_cast<float*>(row_max);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  cudaError_t e;
  if (C % 16 == 0 && addr % 16 == 0) {
    e = launch_band<16>(xi, wf, act_scale, bf16_weights, B, H, W, C, bands, rows, smem,
                        rm, pt, st);
  } else if (C % 4 == 0 && addr % 4 == 0) {
    e = launch_band<4>(xi, wf, act_scale, bf16_weights, B, H, W, C, bands, rows, smem,
                        rm, pt, st);
  } else {
    e = launch_band<1>(xi, wf, act_scale, bf16_weights, B, H, W, C, bands, rows, smem,
                        rm, pt, st);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long per_image = static_cast<long long>(W) * kK;
  const long long total = per_image * B;
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  head_col_reduce_kernel<<<blocks < 4096 ? blocks : 4096, kThreads, 0, st>>>(
      pt, bands, per_image, total, static_cast<float*>(col_max));
  return static_cast<int>(cudaGetLastError());
}
