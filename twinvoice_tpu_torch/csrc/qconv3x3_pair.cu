// K7b on Hopper: the pair-packed int8 3x3 SAME convolution on the int8 tensor
// cores with an s32 sum, then the dequantise -> bias -> (ReLU) -> requantise
// epilogue, int8 in and int8 out, mapping a phase-A input to phase B or a
// phase-B input to phase A.
//
// Replaces twinvoice_tpu/ops/nhwc_conv.py:qconv3x3_pair_requant (its Pallas
// kernel, a rolling-carry row walk over a sequential grid). Blocks here run in
// parallel and in no order, so each block stages its own halo rows.
//
// Layout: x is (N, H, P, Cpk) int8 contiguous, pair p of a row holding two
// neighbouring columns in its Cpk channels: phase A, P = W/2 + 1, pair p holds
// columns (2p-1, 2p) with a zero column baked in on each side of W; phase B,
// P = W/2, pair p holds (2p, 2p+1). wp is (Co2, 3, 2, Cpk) int8: 3 rows times
// 2 pair views, channels innermost. The kernel computes any wp, not only what
// pack_w_pair builds: the decoder's conv1 reads a channel concat of two packed
// sources ([up(2p) | up(2p+1) | skip(2p) | skip(2p+1)]), which is not one
// NHWC pixel, so the pair tensor is convolved as it is.
//
// Math, with delta = 0 for an A input and -1 for a B input:
//   acc[n,h,q,o] = sum_{dy<3, v<2, c<Cpk} x[n, h+dy-1, q+v+delta, c] * wp[o,dy,v,c]
// (rows and pairs outside x read zero; P_out = P - 1 from A, P + 1 from B),
//   y = fma(acc, a2[o], bias2[o])
// one fused multiply-add (__fmaf_rn, one rounding), as XLA computes the JAX
// kernel's acc * a + b under jit, then ReLU when asked and q = rint(y * inv)
// clipped to [0, 127] after a ReLU and to [-127, 127] without one (half to
// even, as jnp.round). A B->A output is phase A: the lower half of pair 0 and
// the upper half of pair P_out - 1 are the baked-in W pad and are written as
// zeros, which the next A->B conv reads.
//
// Bound: at w16, b128, 512^2 the three serving calls move 1.08 GB (A->B,
// Cpk = Co2 = 32) and 1.61 GB (B->A, Cpk = 64), 0.32 and 0.48 ms at
// 3.35 TB/s, against 103 and 207 G MAC (0.10 and 0.21 ms at 1,979 TOP/s int8
// on the tensor cores): bound by bytes. The packing costs 12 MACs of a 3x3
// conv's 9 for each input channel and output channel of a pixel pair's two
// columns (1.33x).
//
// Design: the pair tensor is an NHWC tensor of P pixels a row and Cpk
// channels, and the conv a 3 x 2 window over it read from column delta, so
// K7b is K4a's implicit GEMM (int8_window_conv.cuh, mma.sync m16n8k32 s8 fed
// by ldmatrix) instantiated for a window of 3 rows x KW = 2 columns: M = the
// output pairs of a tile of 16 (8 at more than 32 output channels a block)
// rows x 32 pairs, N = Co2 in blocks of up to 64 channels, K = 6 taps x Cpk.
// Cpk is walked in chunks of 32-128 channels through a cp.async ring, the
// weights staged straight from (Co2, 3, 2, Cpk) in the slab's k order; at
// Cpk <= 16 two taps share a 32-byte k step (3 steps, not 6), at Cpk <= 4
// all six share one. The epilogue is K4a's product form with s0 = 1
// (fma(acc, 1 * a2, b) is fma(acc, a2, b) exactly); a B->A output's pad
// half-pairs are zeroed as the staged tile goes out in 16-byte rows, only at
// the two edge columns. The grid is persistent. The plan (ring slots, chunk, channels a
// block, shared memory, grid) is ops/nhwc_conv.py:pair_plan's.
//
// What holds it back is K4a's (csrc/qconv3x3.cu, PERF.md): at 32 output
// channels a block each A fragment read through ldmatrix feeds four n tiles,
// each slab pixel is read once for each of the 6 taps, and the staging, the
// products and the epilogue of a block run one after another between two
// barriers an item; at Cpk 64 the shared memory leaves a ring of 2 slots.
//
// C interface for ctypes: twv_qconv3x3_pair_requant checks the plan it is
// given, launches on the given stream and returns cudaGetLastError() as an
// int (0 = launched).

#include "int8_window_conv.cuh"

// x: (N, H, P, Cpk) int8 contiguous, phase A when in_phase_a != 0 (P odd) and
// phase B otherwise (P even); wp: (Co2, 3, 2, Cpk) int8 contiguous, Co2 even;
// a2, bias2: (Co2,) float32; out: (N, H, P_out, Co2) int8 contiguous with
// P_out = P - 1 from A and P + 1 from B; all on the device. out_inv =
// float32(127) / float32(out_scale); relu != 0 applies a ReLU. The plan
// (ops/nhwc_conv.py:pair_plan): layout (0 stem, 1 pair, 2 wide), cc channels
// a chunk, nt n tiles of 8 output channels a block, stages slots of the ring,
// smem bytes of dynamic shared memory, blocks along the tiles; gridDim.y is
// ceil(Co2 / (8 nt)).
extern "C" int twv_qconv3x3_pair_requant(const void* x, const void* wp, const void* a2,
                                         const void* bias2, int N, int H, int P,
                                         int Cpk, int Co2, int in_phase_a,
                                         float out_inv, int relu, int layout, int cc,
                                         int nt, int stages, int smem, int blocks,
                                         void* out, void* stream) {
  using namespace twv_window;
  if (P < 1 || Co2 < 2 || Co2 % 2 || P % 2 != (in_phase_a ? 1 : 0) ||
      (in_phase_a && P < 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args p;
  p.x[0] = p.x[1] = static_cast<const int8_t*>(x);
  p.w[0] = p.w[1] = static_cast<const int8_t*>(wp);
  p.w_scale = static_cast<const float*>(a2);
  p.bias = static_cast<const float*>(bias2);
  p.out = static_cast<int8_t*>(out);
  p.H = H;
  p.W = in_phase_a ? P - 1 : P + 1;
  p.Win = P;
  p.pad_w = in_phase_a ? 0 : 1;
  p.Cin = Cpk;
  p.Co = Co2;
  const int err = plan_args<2>(p, N, 1, false, layout, cc, nt, stages, smem, blocks);
  if (err) return err;
  p.zero_pad = !in_phase_a;
  p.s0 = 1.0f;
  p.s1 = 0.0f;
  p.inv = out_inv;
  p.mode = kProd;
  p.relu = relu;
  const int n_co = (Co2 + 8 * nt - 1) / (8 * nt);
  return launch_layout<false, 2>(p, layout, nt, smem, blocks, n_co,
                                 static_cast<cudaStream_t>(stream));
}
