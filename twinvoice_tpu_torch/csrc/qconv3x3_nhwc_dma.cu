// K3a on Hopper: int8 3x3 convolution of a caller-padded NHWC input, H-pad rows
// included, with an s32 sum, then the dequantise -> bias -> (ReLU) ->
// requantise epilogue, int8 in and int8 out.
//
// Replaces twinvoice_tpu/ops/nhwc_conv.py:qconv3x3_nhwc_dma, the Pallas kernel
// with a grid of one step per image and an in-loop two-slot manual DMA ring of
// (th + 2)-row slabs (the design the TPU compiler of its day could not build).
//
// Contract (the JAX kernel's): x_pad is (N, H+2, W+2, C) int8 NHWC-contiguous,
// padded by the caller, and every row of it is read, the H-pad rows included
// (JAX's slab x_hbm[b, blk*th : blk*th + th + 2]); so
//   acc[n,h,w,o] = sum_{dy,dx<3, c<C} x_pad[n, h+dy, w+dx, c] * wt[o,dy,dx,c]
//   y = fma(acc, a[o], bias[o])    (one rounding, as XLA fuses JAX's acc*a + b)
// then ReLU when asked and q = rint(y * inv) clipped to [0, 127] after a ReLU
// and to [-127, 127] without one. With zero pad rows this equals K3b
// (csrc/qconv3x3_nhwc_requant.cu), which reads them as zeros whatever they hold.
//
// Bound: at the reference's flagship shape (the w64 model's enc0 conv2, b128,
// 512^2, 64 -> 64) the call reads 2.164 GB and writes 2.147 GB, 1.29 ms at
// 3.35 TB/s, against 2.47 T int8 operations, 1.25 ms at 1,979 TOP/s on the
// tensor cores: bound by bytes. This kernel multiplies on the CUDA cores
// (__dp4a), which sets its own ceiling well above both.
//
// Design, the counterpart of the DMA ring: a block owns one image and 16
// output channels and walks the image's 8 x 32 output tiles in order; each
// tile's (8 + 2) x (32 + 2) input slab, 64 channels at a time, streams through
// a two-slot cp.async ring in shared memory, so the copy of slab t + 1
// overlaps the multiply-adds on slab t (csrc/int8_conv_slab_ring.cuh). The
// JAX kernel's output ring has no counterpart: each thread stores its own
// pixel's 16 channels as one 16-byte write.
//
// C interface for ctypes: twv_qconv3x3_nhwc_dma launches on the given stream
// and returns cudaGetLastError() as an int (0 = launched).

#include "int8_conv_slab_ring.cuh"

// x: (N, H+2, W+2, C) int8 contiguous; w: [9][CW][CoP] int32 words (channels
// 4q..4q+3 of tap dy*3+dx for output channel o at [tap][q][o]; zero past C and
// Co; 4*CW a multiple of chunk, CoP a multiple of 64 >= Co); chunk: channels
// of a ring unit, a multiple of 16; a, bias: (Co,) float32; out: (N, H, W, Co)
// int8 contiguous; all on the device. out_inv = float32(127) /
// float32(out_scale); relu != 0 applies a ReLU. in_phase_a must be 0 (K7a's
// argument, kept so that K3b, K3a and K7a share one C signature).
extern "C" int twv_qconv3x3_nhwc_dma(const void* x, const void* w, const void* a,
                                     const void* bias, int N, int H, int W, int C, int Co,
                                     int chunk, int CW, int CoP, int in_phase_a,
                                     float out_inv, int relu, void* out, void* stream) {
  if (in_phase_a != 0) return static_cast<int>(cudaErrorInvalidValue);
  twv::SlabArgs p{};
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int4*>(w);
  p.a = static_cast<const float*>(a);
  p.bias = static_cast<const float*>(bias);
  p.Hin = H + 2;
  p.Win = W + 2;
  p.C = C;
  p.H = H;
  p.W = W;
  p.Co = Co;
  p.chunk = chunk;
  p.CW = CW;
  p.CoP = CoP;
  p.row_off = 0;
  p.col_off = 0;
  p.inv = out_inv;
  p.relu = relu;
  p.zero_pad_pairs = false;
  p.out = static_cast<int8_t*>(out);
  return twv::launch_slab_ring<3>(p, N, static_cast<cudaStream_t>(stream));
}
