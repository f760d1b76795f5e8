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
// on the tensor cores near their peak for the bytes to be the limit at all.
//
// Design: the manual DMA ring becomes K3a's TMA ring feeding wgmma
// (int8_tma_conv.cuh) over the unpadded input: every box starts a row above
// and a column left of its tile (row_off = col_off = -1), so TMA writes the
// whole zero SAME halo itself (coordinates outside x read zero), as it does
// K7a's H halo, and the ragged last tile costs no code either. Where no
// tensor map is legal (Cin % 16 != 0, or x not 16-byte aligned) the
// producer warp copies the same layout itself, zeros outside x.
//
// C interface for ctypes: twv_qconv3x3_requant_dma checks the plan it is
// given, launches on the given stream and returns 0, a cudaError_t, or an
// error of the tensor-map encoder (int8_tma_conv.cuh).

#include "int8_tma_conv.cuh"

constexpr int kMaxCin = 128;  // one Cin chunk, as the JAX kernel asserts

// x: (N, H, W, Cin) int8 contiguous; w: the packed weights of
// ops/nhwc_conv.py:pack_dma_weights for the plan; a, bias: (Co,) float32;
// out: (N, H, W, Co) int8 contiguous; all on the device. out_inv =
// float32(127) / float32(out_scale); relu != 0 applies a ReLU. The plan:
// cot, chunk, stages, resident, tma_in, tma_out, smem, blocks
// (ops/nhwc_conv.py:dma_plan).
extern "C" int twv_qconv3x3_requant_dma(const void* x, const void* w, const void* a,
                                        const void* bias, int N, int H, int W, int Cin, int Co,
                                        int cot, int chunk, int stages, int resident,
                                        int tma_in, int tma_out, int smem, int blocks,
                                        float out_inv, int relu, void* out, void* stream) {
  if (Cin > kMaxCin) return static_cast<int>(cudaErrorInvalidValue);
  twv_tma::Args p{};
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.a = static_cast<const float*>(a);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<int8_t*>(out);
  p.N = N;
  p.Hin = H;
  p.Himg = H;
  p.Win = W;
  p.C = Cin;
  p.H = H;
  p.W = W;
  p.Co = Co;
  p.row_off = -1;
  p.col_off = -1;
  p.zero_pad = false;
  p.inv = out_inv;
  p.relu = relu;
  return twv_tma::launch<3>(p, cot, chunk, stages, resident, tma_in, tma_out, smem, blocks,
                            static_cast<cudaStream_t>(stream));
}
