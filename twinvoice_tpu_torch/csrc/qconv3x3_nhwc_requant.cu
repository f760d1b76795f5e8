// K3b on Hopper: int8 3x3 convolution of a caller-padded NHWC input with an
// s32 sum, then the dequantise -> bias -> (ReLU) -> requantise epilogue, int8
// in and int8 out.
//
// Replaces twinvoice_tpu/ops/nhwc_conv.py:qconv3x3_nhwc_requant, the
// rolling-carry Pallas kernel: a sequential grid walks down each image and
// keeps the previous row block and a one-row carry in VMEM, so every input row
// is read from HBM once. Blocks here run in parallel, so each block walks down
// a segment of rows of its own and carries a ring of rows in shared memory.
//
// Contract (the JAX kernel's): x_pad is (N, H+2, W+2, C) int8 NHWC-contiguous,
// padded by the caller. The kernel drops the two H-pad rows (JAX's
// x_pad[:, 1:-1]) and uses zero rows as the top and bottom halo instead; the
// W-pad columns are read from memory as they lie. So, with x_pad rows 0 and
// H+1 read as zero,
//   acc[n,h,w,o] = sum_{dy,dx<3, c<C} x_pad[n, h+dy, w+dx, c] * wt[o,dy,dx,c]
//   y = fma(acc, a[o], bias[o])    (one rounding, as XLA fuses JAX's acc*a + b)
// then ReLU when asked and q = rint(y * inv) clipped to [0, 127] after a ReLU
// and to [-127, 127] without one. a = s_in * w_scale is the caller's.
//
// Bound: at the reference's flagship shape (the w64 model's enc0 conv2, b128,
// 512^2, 64 -> 64) the call reads 2.156 GB (the H-pad rows are not read) and
// writes 2.147 GB, 1.28 ms at 3.35 TB/s, against 2.47 T int8 operations,
// 1.25 ms at 1,979 TOP/s on the tensor cores: bound by bytes. This kernel multiplies on the CUDA cores
// (__dp4a: four int8 products and an s32 add an instruction), as K4a does,
// which sets its own ceiling well above both; the tensor-core ring is K4b's
// (csrc/qconv3x3_requant_dma.cu).
//
// Design, the counterpart of the rolling carry: a block owns a strip of 32
// output columns, up to 64 output channels (one warp for each 16) and a
// segment of kSeg output rows of one image, and walks down the segment one
// output row a step. Shared memory holds a ring of four padded input rows of
// the strip (34 pixels, all C channels): the three the step reads and the one
// cp.async is bringing in for the next step, so a row is copied in once and
// read by three steps, and the copy overlaps the multiply-adds. Because the
// halo is in memory, nothing is bounds-checked but the strip's ragged end.
// A thread holds one output pixel's 16 s32 sums. The weights are read from
// global memory (L1) as [tap][word][co] words, prepacked by the wrapper; every
// thread of a warp reads the same 16 bytes at once.
//
// C interface for ctypes: twv_qconv3x3_nhwc_requant launches on the given
// stream and returns cudaGetLastError() as an int (0 = launched).

#include <cstdint>

#include <cuda_runtime.h>

#include "int8_conv_common.cuh"

namespace {

constexpr int kTW = 32;       // output columns of a strip
constexpr int kCoT = 16;      // output channels of a warp
constexpr int kMaxWarps = 4;  // warps (16-channel groups) of a block
constexpr int kRing = 4;      // rows in the ring
constexpr int kSeg = 32;      // output rows of a block

struct Args {
  const int8_t* x;
  const int4* w;  // [9][CW][CoP] int32 words of four channels, CW = 4 x granules
  const float* a;
  const float* bias;
  int H, W, C, Co, CW, CoP, n_seg, n_co;
  float inv;
  int relu;
  bool vec_in, vec_out;
  int8_t* out;
};

// Padded row e (0..H+1) of the strip starting at padded column w0 into ring
// slot dst: rows 0 and H+1 (the H pad) and columns past W+1 as zeros.
__device__ void stage_row(const Args& p, uint8_t* dst, int n, int e, int w0, int pb) {
  const bool live = e >= 1 && e <= p.H;
  const int Wp = p.W + 2;
  const int8_t* row = p.x + (static_cast<long long>(n) * (p.H + 2) + e) * Wp * p.C;
  if (p.vec_in) {
    const int g16 = pb / 16;
    for (int i = threadIdx.x; i < (kTW + 2) * g16; i += blockDim.x) {
      const int px = i / g16;
      const int k = i - px * g16;
      const bool ok = live && w0 + px < Wp && 16 * k < p.C;
      const int8_t* src = ok ? row + static_cast<long long>(w0 + px) * p.C + 16 * k : p.x;
      twv::cp_async16(dst + px * pb + 16 * k, src, ok ? 16 : 0);
    }
  } else {
    const int words = pb / 4;
    for (int i = threadIdx.x; i < (kTW + 2) * words; i += blockDim.x) {
      const int px = i / words;
      const int q = i - px * words;
      int v = 0;
      if (live && w0 + px < Wp) {
        v = twv::load_word(row + static_cast<long long>(w0 + px) * p.C, 4 * q, p.C);
      }
      reinterpret_cast<int*>(dst)[px * words + q] = v;
    }
  }
}

__global__ void __launch_bounds__(kTW * kMaxWarps)
qconv3x3_nhwc_requant_kernel(Args p) {
  extern __shared__ __align__(16) uint8_t ring[];
  const int pb = twv::pixel_bytes(p.C);
  const int row_bytes = (kTW + 2) * pb;
  const int w0 = blockIdx.x * kTW;
  const int co_tile = blockIdx.y;
  const int n = blockIdx.z / p.n_seg;
  const int r0 = (blockIdx.z % p.n_seg) * kSeg;
  const int r1 = min(r0 + kSeg, p.H);
  const int tx = threadIdx.x % kTW;
  const int warp = threadIdx.x / kTW;
  const int co0 = (co_tile * (blockDim.x / kTW) + warp) * kCoT;

  // prologue: padded rows r0..r0+3, one cp.async group each
  for (int i = 0; i < kRing; ++i) {
    stage_row(p, ring + ((r0 + i) % kRing) * row_bytes, n, r0 + i, w0, pb);
    twv::cp_async_commit();
  }
  float a[kCoT], b[kCoT];
#pragma unroll
  for (int j = 0; j < kCoT; ++j) {
    const int co = co0 + j;
    a[j] = co < p.Co ? p.a[co] : 0.0f;
    b[j] = co < p.Co ? p.bias[co] : 0.0f;
  }
  const int q16 = p.CW / 4;  // 16-channel granules
  const int wrow = p.CoP / 4;  // int4 of one [tap][word] row of weights

  for (int r = r0; r < r1; ++r) {
    twv::cp_async_wait<1>();  // rows r..r+2 have landed; r+3 may be in flight
    __syncthreads();
    int acc[kCoT];
#pragma unroll
    for (int j = 0; j < kCoT; ++j) acc[j] = 0;
    if (co0 < p.Co) {
      for (int dy = 0; dy < 3; ++dy) {
        const uint8_t* rowp = ring + ((r + dy) % kRing) * row_bytes;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int4* xp = reinterpret_cast<const int4*>(rowp + (tx + dx) * pb);
          const int4* wp = p.w + static_cast<long long>((dy * 3 + dx) * p.CW) * wrow + co0 / 4;
          for (int k = 0; k < q16; ++k) {
            const int4 xv = xp[k];
            const int xw[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int4* wq = wp + static_cast<long long>(4 * k + q) * wrow;
              const int4 w0v = __ldg(wq), w1v = __ldg(wq + 1), w2v = __ldg(wq + 2),
                         w3v = __ldg(wq + 3);
              const int wv[kCoT] = {w0v.x, w0v.y, w0v.z, w0v.w, w1v.x, w1v.y, w1v.z, w1v.w,
                                    w2v.x, w2v.y, w2v.z, w2v.w, w3v.x, w3v.y, w3v.z, w3v.w};
#pragma unroll
              for (int j = 0; j < kCoT; ++j) acc[j] = __dp4a(xw[q], wv[j], acc[j]);
            }
          }
        }
      }
    }
    __syncthreads();  // the slot of row r is free
    stage_row(p, ring + ((r + kRing) % kRing) * row_bytes, n, r + kRing, w0, pb);
    twv::cp_async_commit();

    const int wc = w0 + tx;
    if (co0 >= p.Co || wc >= p.W) continue;
    unsigned packed[kCoT / 4] = {};
#pragma unroll
    for (int j = 0; j < kCoT; ++j) {
      packed[j / 4] |= twv::requant_fma(acc[j], a[j], b[j], p.inv, p.relu) << (8 * (j % 4));
    }
    int8_t* o = p.out + ((static_cast<long long>(n) * p.H + r) * p.W + wc) * p.Co + co0;
    if (p.vec_out) {
      *reinterpret_cast<int4*>(o) = make_int4(packed[0], packed[1], packed[2], packed[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kCoT; ++j) {
        if (co0 + j < p.Co) o[j] = static_cast<int8_t>(packed[j / 4] >> (8 * (j % 4)));
      }
    }
  }
  twv::cp_async_wait<0>();
}

}  // namespace

// x: (N, H+2, W+2, C) int8 contiguous; w: [9][CW][CoP] int32 words (channels
// 4q..4q+3 of tap dy*3+dx for output channel o at [tap][q][o]; zero past C and
// Co; CW = C rounded up to 16, over 4; CoP a multiple of 64 >= Co); a, bias: (Co,) float32;
// out: (N, H, W, Co) int8 contiguous; all on the device. out_inv =
// float32(127) / float32(out_scale); relu != 0 applies a ReLU.
extern "C" int twv_qconv3x3_nhwc_requant(const void* x, const void* w, const void* a,
                                         const void* bias, int N, int H, int W, int C,
                                         int Co, int CW, int CoP, float out_inv, int relu,
                                         void* out, void* stream) {
  const int warps = Co >= 4 * kCoT ? 4 : (Co + kCoT - 1) / kCoT;
  const int n_co = (Co + warps * kCoT - 1) / (warps * kCoT);
  const int n_seg = (H + kSeg - 1) / kSeg;
  const size_t smem = static_cast<size_t>(kRing) * (kTW + 2) * twv::pixel_bytes(C);
  if (N < 1 || H < 1 || W < 1 || C < 1 || Co < 1 ||
      CW != (C + 15) / 16 * 4 || CoP % 64 ||
      CoP < Co || static_cast<long long>(N) * n_seg > 65535 || n_co > 65535 ||
      smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        qconv3x3_nhwc_requant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Args p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int4*>(w);
  p.a = static_cast<const float*>(a);
  p.bias = static_cast<const float*>(bias);
  p.H = H;
  p.W = W;
  p.C = C;
  p.Co = Co;
  p.CW = CW;
  p.CoP = CoP;
  p.n_seg = n_seg;
  p.n_co = n_co;
  p.inv = out_inv;
  p.relu = relu;
  p.vec_in = C % 16 == 0 && twv::aligned(x, 16);
  p.vec_out = Co % kCoT == 0 && twv::aligned(out, 16);
  p.out = static_cast<int8_t*>(out);
  const dim3 grid((W + kTW - 1) / kTW, n_co, N * n_seg);
  qconv3x3_nhwc_requant_kernel<<<grid, kTW * warps, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
