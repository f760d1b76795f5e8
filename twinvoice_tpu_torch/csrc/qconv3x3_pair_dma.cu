// K7a on Hopper: the pair-packed int8 3x3 SAME convolution with an s32 sum,
// then the dequantise -> bias -> (ReLU) -> requantise epilogue, int8 in and
// int8 out, mapping a phase-A input to phase B or a phase-B input to phase A.
//
// Replaces twinvoice_tpu/ops/nhwc_conv.py:qconv3x3_pair_dma, the Pallas kernel
// with a grid of one step per image and an in-loop two-slot manual DMA ring of
// (th + 2)-row pair slabs (the design the TPU compiler of its day could not
// build). Its contract is K7b's (csrc/qconv3x3_pair.cu), whose note defines
// the phases: x is (N, H, P, Cpk) int8, pair p of a row holding two
// neighbouring columns in its Cpk channels, H unpadded; wp is (Co2, 3, 2,
// Cpk) int8, any packing. With delta = 0 for an A input and -1 for a B input,
//   acc[n,h,q,o] = sum_{dy<3, v<2, c<Cpk} x[n, h+dy-1, q+v+delta, c] * wp[o,dy,v,c]
// (rows outside the image are the zero H halo, pairs outside x the zero slab
// edges of a B input; P_out = P - 1 from A, P + 1 from B),
//   y = fma(acc, a2[o], bias2[o])  (one rounding, as XLA fuses JAX's acc*a + b)
// then ReLU when asked and q = rint(y * inv) clipped to [0, 127] after a ReLU
// and to [-127, 127] without one. A B->A output is phase A: the lower half of
// pair 0 and the upper half of pair P_out - 1 are its baked-in W pad and are
// written as zeros (JAX's iota mask).
//
// Bound: at the reference's flagship shape packed to phase A (b128, 512 rows,
// 257 pairs of 128 channels -> 256 pairs of 128) the call does 3.30 T int8
// operations, 1.67 ms at 1,979 TOP/s on the tensor cores, against 4.3 GB
// moved, 1.28 ms at 3.35 TB/s: bound by operations (the packing does 12
// multiply-adds for a 3x3 conv's 9). This kernel multiplies on the CUDA cores
// (__dp4a), which sets its own ceiling well above both.
//
// Design: K7b's pair arithmetic (6 taps: 3 rows by 2 pair views of all Cpk
// channels), fed as K3a is fed: a block owns one image and 16 output
// channels and walks its 8 x 32 output-pair tiles in order, each tile's
// (8 + 2) x (32 + 1) slab of input pairs, 64 channels at a time, streaming
// through a two-slot cp.async ring in shared memory while the block multiplies
// the slab before it (csrc/int8_conv_slab_ring.cuh). The zero H halo and slab
// edges are written into the slot, not read.
//
// C interface for ctypes: twv_qconv3x3_pair_dma launches on the given stream
// and returns cudaGetLastError() as an int (0 = launched).

#include "int8_conv_slab_ring.cuh"

// x: (N, H, P, Cpk) int8 contiguous, phase A when in_phase_a != 0 (P odd) and
// phase B otherwise (P even); w: [6][CW][CoP] int32 words (channels 4q..4q+3
// of tap dy*2+v for output channel o at [tap][q][o]; zero past Cpk and Co2;
// 4*CW a multiple of chunk, CoP a multiple of 64 >= Co2); chunk: channels of a
// ring unit, a multiple of 16; a2, bias2: (Co2,) float32; out: (N, H, P_out,
// Co2) int8 contiguous with P_out = P - 1 from A and P + 1 from B; all on the
// device. out_inv = float32(127) / float32(out_scale); relu != 0 applies a
// ReLU.
extern "C" int twv_qconv3x3_pair_dma(const void* x, const void* w, const void* a2,
                                     const void* bias2, int N, int H, int P, int Cpk,
                                     int Co2, int chunk, int CW, int CoP, int in_phase_a,
                                     float out_inv, int relu, void* out, void* stream) {
  if (P < 1 || Co2 < 2 || Co2 % 2 || P % 2 != (in_phase_a ? 1 : 0) || (in_phase_a && P < 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  twv::SlabArgs p{};
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int4*>(w);
  p.a = static_cast<const float*>(a2);
  p.bias = static_cast<const float*>(bias2);
  p.Hin = H;
  p.Win = P;
  p.C = Cpk;
  p.H = H;
  p.W = in_phase_a ? P - 1 : P + 1;
  p.Co = Co2;
  p.chunk = chunk;
  p.CW = CW;
  p.CoP = CoP;
  p.row_off = -1;
  p.col_off = in_phase_a ? 0 : -1;
  p.inv = out_inv;
  p.relu = relu;
  p.zero_pad_pairs = !in_phase_a;
  p.out = static_cast<int8_t*>(out);
  return twv::launch_slab_ring<2>(p, N, static_cast<cudaStream_t>(stream));
}
