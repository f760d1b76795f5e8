// K3b on Hopper: int8 3x3 convolution of a caller-padded NHWC input whose two
// H-pad rows are read as zeros, with an s32 sum, then the dequantise -> bias
// -> (ReLU) -> requantise epilogue, int8 in and int8 out.
//
// Replaces twinvoice_tpu/ops/nhwc_conv.py:qconv3x3_nhwc_requant, the
// rolling-carry Pallas kernel: a sequential grid walks down each image and
// keeps the previous row block and a one-row carry in VMEM, so every input row
// is read from HBM once.
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
// 1.25 ms at 1,979 TOP/s on the tensor cores: bound by bytes, with the
// operations close behind.
//
// Design: K3a's TMA ring and wgmma consumers (int8_tma_conv.cuh) over rows 1
// .. H of x_pad only. The input the kernel sees starts at row 1 and has H
// visible rows of W + 2 columns, its images (H + 2) (W + 2) C bytes apart;
// every box starts a row above its tile (row_off = -1), so TMA writes the
// zero top and bottom halo itself and never reads the live pad rows, and the
// W-pad columns come from memory (col_off = 0). Where no tensor map is legal
// (C % 16 != 0, or row 1 not 16-byte aligned) the producer warp copies the
// same rows and writes zeros for the rest.
//
// C interface for ctypes: twv_qconv3x3_nhwc_requant checks the plan it is
// given, launches on the given stream and returns 0, a cudaError_t, or an
// error of the tensor-map encoder (int8_tma_conv.cuh).

#include "int8_tma_conv.cuh"

// x: (N, H+2, W+2, C) int8 contiguous; w: the packed weights of
// ops/nhwc_conv.py:pack_dma_weights for the plan; a, bias: (Co,) float32;
// out: (N, H, W, Co) int8 contiguous; all on the device. out_inv =
// float32(127) / float32(out_scale); relu != 0 applies a ReLU. The plan:
// cot, chunk, stages, resident, tma_in, tma_out, smem, blocks
// (ops/nhwc_conv.py:dma_plan).
extern "C" int twv_qconv3x3_nhwc_requant(const void* x, const void* w, const void* a,
                                         const void* bias, int N, int H, int W, int C, int Co,
                                         int cot, int chunk, int stages, int resident,
                                         int tma_in, int tma_out, int smem, int blocks,
                                         float out_inv, int relu, void* out, void* stream) {
  twv_tma::Args p{};
  p.x = static_cast<const int8_t*>(x) + static_cast<long long>(W + 2) * C;  // row 1
  p.w = static_cast<const int8_t*>(w);
  p.a = static_cast<const float*>(a);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<int8_t*>(out);
  p.N = N;
  p.Hin = H;
  p.Himg = H + 2;
  p.Win = W + 2;
  p.C = C;
  p.H = H;
  p.W = W;
  p.Co = Co;
  p.row_off = -1;
  p.col_off = 0;
  p.zero_pad = false;
  p.inv = out_inv;
  p.relu = relu;
  return twv_tma::launch<3>(p, cot, chunk, stages, resident, tma_in, tma_out, smem, blocks,
                            static_cast<cudaStream_t>(stream));
}
