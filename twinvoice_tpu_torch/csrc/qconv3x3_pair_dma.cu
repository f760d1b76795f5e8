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
// multiply-adds for a 3x3 conv's 9).
//
// Design: K3a's TMA ring (int8_tma_conv.cuh) over a 3 x 2 window of pairs: the
// producer's box starts at row h0 - 1 and pair q0 + delta, and TMA writes the
// zero H halo and a B input's zero slab edges itself (coordinates past the
// tensor read zero), which the JAX kernel zeroes by hand in its slots. The
// 6 taps are wgmma products at shifted descriptor addresses; a B->A output's
// pad half-pairs are zeroed in the shared-memory tile before its TMA store.
//
// C interface for ctypes: twv_qconv3x3_pair_dma checks the plan it is given,
// launches on the given stream and returns 0, a cudaError_t, or an error of
// the tensor-map encoder (int8_tma_conv.cuh).

#include "int8_tma_conv.cuh"

// x: (N, H, P, Cpk) int8 contiguous, phase A when in_phase_a != 0 (P odd, at
// least 3) and phase B otherwise (P even); w: the packed weights of
// ops/nhwc_conv.py:pack_dma_weights for the plan; a2, bias2: (Co2,) float32
// with Co2 even; out: (N, H, P_out, Co2) int8 contiguous with P_out = P - 1
// from A and P + 1 from B; all on the device. out_inv = float32(127) /
// float32(out_scale); relu != 0 applies a ReLU. The plan: cot, chunk,
// stages, resident, tma_in, tma_out, smem, blocks (ops/nhwc_conv.py:dma_plan).
extern "C" int twv_qconv3x3_pair_dma(const void* x, const void* w, const void* a2,
                                     const void* bias2, int N, int H, int P, int Cpk,
                                     int Co2, int in_phase_a, int cot, int chunk, int stages,
                                     int resident, int tma_in, int tma_out, int smem,
                                     int blocks, float out_inv, int relu, void* out,
                                     void* stream) {
  if (P < 1 || Co2 < 2 || Co2 % 2 || P % 2 != (in_phase_a ? 1 : 0) || (in_phase_a && P < 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  twv_tma::Args p{};
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.a = static_cast<const float*>(a2);
  p.bias = static_cast<const float*>(bias2);
  p.out = static_cast<int8_t*>(out);
  p.N = N;
  p.Hin = H;
  p.Himg = H;
  p.Win = P;
  p.C = Cpk;
  p.H = H;
  p.W = in_phase_a ? P - 1 : P + 1;
  p.Co = Co2;
  p.row_off = -1;
  p.col_off = in_phase_a ? 0 : -1;
  p.zero_pad = !in_phase_a;
  p.inv = out_inv;
  p.relu = relu;
  return twv_tma::launch<2>(p, cot, chunk, stages, resident, tma_in, tma_out, smem, blocks,
                            static_cast<cudaStream_t>(stream));
}
