// K4a and K5 on Hopper: int8 3x3 SAME convolution on the int8 tensor cores
// with an s32 sum, then the dequantise -> bias -> (ReLU) -> requantise
// epilogue, int8 in and int8 out.
//
// Replaces twinvoice_tpu/ops/qconv_pallas.py:qconv3x3_requant (K4a) and
// :qconv3x3_split_requant (K5), which share one Pallas kernel factory
// (`_make_qconv_kernel`); here they share one kernel template. K5 takes a
// second input and a second weight (the decoder's upsample and skip halves)
// whose products go into the same s32 sum, or into a second one for the
// split XLA form of quant.py:242, where the two halves keep their own scales.
//
// Contract: activations are NHWC-contiguous int8 (channels innermost, the
// order the tensor cores take along k); weights are (Co, 3, 3, Cin) int8 and
// are read as they lie; any N, H, W, Cin >= 1, Co >= 1, aligned or not. SAME
// padding is written into the staged slab as zeros: the TPU's zero-bordered
// (H+8, C, W+64, N) frame is not carried over.
//
// Epilogue, with acc the s32 sum, w = w_scale[co] and b = bias[co], in the
// association of the JAX call site and rounded where JAX rounds: under jit,
// XLA fuses a multiply and the add that consumes it into one fused
// multiply-add (FMA, __fmaf_rn, one rounding), and every other step is one
// correctly rounded float32 operation (__fmul_rn):
//   kProd     fma(acc, s0 * w, b)                  quant._qconv, the Pallas kernels
//   kChain    fma(acc * s0, w, b)                  the concat decoder, quant.py:237
//   kSeparate fma(fma(acc1, s0, acc2 * s1), w, b)  the split decoder, quant.py:242
// (tests/test_torch_epilogue.py finds each form in JAX at searched ties), then
// ReLU when asked, q = rint(y * inv) clipped to [0, 127] after a ReLU and to
// [-127, 127] without one (round half to even, as jnp.round). The s32 sum is
// exact in any order, so the result does not depend on the k order below.
//
// Bound, at b128 on the H100 SXM (3.35 TB/s, 1,979 TOP/s int8 dense), each
// input byte read once and each output byte written once:
//   shape (side, Cin -> Co)            bytes      int8 ops   bound ms  by
//   512, 3 -> 16 (stem)                637.5 MB    29.0 G    0.1903   bytes
//   512, 16 -> 16                     1073.7 MB   154.6 G    0.3205   bytes
//   512, 32 -> 16 / K5 16+16 -> 16    1610.6 MB   309.2 G    0.4808   bytes
//   256, 16 -> 32                      402.7 MB    77.3 G    0.1202   bytes
//   256, 32 -> 32                      536.9 MB   154.6 G    0.1603   bytes
//   256, 64 -> 32 / K5 32+32 -> 32     805.3 MB   309.2 G    0.2404   bytes
//   128, 32 -> 64                      201.3 MB    77.3 G    0.0601   bytes
//   128, 64 -> 64                      268.5 MB   154.6 G    0.0801   bytes
//   128, 128 -> 64 / K5 64+64 -> 64    402.7 MB   309.2 G    0.1563   operations
//   64, 64 -> 128                      100.7 MB    77.3 G    0.0391   operations
//   64, 128 -> 128                     134.4 MB   154.6 G    0.0781   operations
//   64, 256 -> 128 / K5 128+128 -> 128 201.6 MB   309.2 G    0.1563   operations
//   32, 128 -> 256                      50.6 MB    77.3 G    0.0391   operations
//   32, 256 -> 256                      67.7 MB   154.6 G    0.0781   operations
// The full-resolution layers, which take most of the time, are bound by
// bytes; the deep ones by operations, and then only on the tensor cores.
//
// Design: an implicit GEMM, M = output pixels, N = output channels, K = taps
// x channels, on mma.sync m16n8k32 s8 (int8_mma_conv.cuh). A block owns
// 8 * NT output channels (NT = 1, 2, 4 or 8: up to 64, so for Co <= 64 the
// input is read from device memory once; K5's two-sum form caps NT at 2 so its
// two register tiles do not spill) and walks output tiles of 16 x 32 pixels
// (8 x 32 at NT = 8) over the batch (a persistent grid: the wrapper sizes it
// to the blocks that fit on the card, three an SM at NT <= 2, else two). Each
// of the 8 warps computes two output rows of the tile (one at NT = 8): four
// (two) 16-pixel m tiles by NT 8-channel n tiles. Per tile, the block walks
// "items": Cin in chunks of cc channels, and for K5 the chunks of the first
// input and then of the second. Each item's (rows + 2) x (32 + 2) halo slab,
// zeros outside the image and past Cin, lands in a cp.async ring of 2 to 4
// slots in shared memory, so the next items are in flight while the tensor
// cores work on this one; the s32 sums stay in registers across the items of
// a tile. The weights are staged straight from the (Co, 3, 3, Cin) tensor in
// the slab's k order, zeros in the padding slots: once for the block's life
// when a tile has no more items than the ring has slots, else through the
// ring beside the slab. The k order has three layouts, so that narrow inputs
// do not feed the tensor cores zeros:
//   kStem (Cin <= 4)   eight taps of 4 channels a 32-wide k step: 2 steps, not
//                      9. A pixel is one word in the slab and A is loaded with
//                      lds.32 (ldmatrix cannot gather four pixels into a row);
//                      its 3-byte pixels are too narrow for cp.async, so the
//                      slab comes through registers, loaded two items ahead.
//   kPair (Cin <= 16)  two taps of 16 channels a k step (a0/a1 tap t, a2/a3 tap
//                      t + 1): 5 steps, not 9.
//   kWide (Cin > 16)   32 channels of one tap a k step, cc = 32, 64 or 128
//                      channels a chunk.
// A fragments of kPair and kWide are one ldmatrix.x4 per 16 x 32-byte
// fragment, each lane pointing at its own shifted pixel row; B fragments are
// one ldmatrix.x4 per two n tiles. Slab pixels and weight rows sit at an odd
// number of 16-byte granules, so the eight rows of an ldmatrix matrix hit
// eight different bank groups. The int8 results go through shared memory and
// out as whole 16-byte rows when Co % 16 == 0 and the pointer is aligned, byte
// by byte otherwise.
//
// What holds it back (PERF.md): an A fragment read from shared memory feeds
// only NT n tiles, so at Co = 16 ldmatrix's bandwidth caps the tensor cores
// near half rate, and each slab pixel is read once for each of the 9 taps; the
// staging, the products and the epilogue of a block run one after another
// between its two barriers an item.
//
// Not wgmma yet: wgmma reads A from shared memory in core matrices of 8 rows x
// 16 bytes laid out for one GEMM, and a shifted 3x3 window is a different
// row set for each of the 9 taps, so each column shift would need the slab
// restaged (or A kept in registers, which costs wgmma its asynchrony); nor
// TMA, whose boxes do not zero-fill a halo past Cin at the chunk granularity
// used here. Both are later work.
//
// The kernel template is int8_window_conv.cuh's (KW = 3), which K7b
// (csrc/qconv3x3_pair.cu) instantiates with KW = 2.
//
// C interface for ctypes: twv_qconv3x3_requant checks the plan it is given
// (layout, chunk, Co tile, shared-memory bytes, grid; computed by
// ops/qconv.py:conv_plan), launches on the given stream and returns
// cudaGetLastError() as an int (0 = launched).

#include "int8_window_conv.cuh"

// x: (N, H, W, Cin) int8 NHWC-contiguous; w: (Co, 3, 3, Cin) int8 contiguous;
// x2, w2: the second input and weight of K5 (same shapes), or null for one
// input; w_scale, bias: (Co,) float32; out: (N, H, W, Co) int8 contiguous;
// all on the device. s0, s1, out_inv and the mode are the epilogue's (see the
// note above); relu != 0 applies a ReLU. The plan (ops/qconv.py:conv_plan):
// layout (0 stem, 1 pair, 2 wide), cc channels a chunk (4, 16, or 32, 64,
// 128), nt n tiles of 8 output channels a block, stages slots of the ring
// (2 to 4), smem bytes of dynamic shared memory, blocks along the tiles;
// gridDim.y is ceil(Co / (8 nt)).
extern "C" int twv_qconv3x3_requant(const void* x, const void* x2, const void* w,
                                    const void* w2, const void* w_scale,
                                    const void* bias, int N, int H, int W, int Cin,
                                    int Co, float s0, float s1, float out_inv,
                                    int mode, int relu, int layout, int cc, int nt,
                                    int stages, int smem, int blocks, void* out,
                                    void* stream) {
  using namespace twv_window;
  const bool sep = mode == kSeparate;
  if (mode < kProd || mode > kSeparate || (sep && !x2) || (!x2 != !w2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args p;
  p.x[0] = static_cast<const int8_t*>(x);
  p.x[1] = x2 ? static_cast<const int8_t*>(x2) : p.x[0];
  p.w[0] = static_cast<const int8_t*>(w);
  p.w[1] = w2 ? static_cast<const int8_t*>(w2) : p.w[0];
  p.w_scale = static_cast<const float*>(w_scale);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<int8_t*>(out);
  p.H = H;
  p.W = W;
  p.Win = W;
  p.pad_w = 1;
  p.Cin = Cin;
  p.Co = Co;
  const int err =
      plan_args<3>(p, N, x2 ? 2 : 1, sep, layout, cc, nt, stages, smem, blocks);
  if (err) return err;
  p.zero_pad = false;
  p.s0 = s0;
  p.s1 = s1;
  p.inv = out_inv;
  p.mode = mode;
  p.relu = relu;
  const int n_co = (Co + 8 * nt - 1) / (8 * nt);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return sep ? launch_layout<true, 3>(p, layout, nt, smem, blocks, n_co, st)
             : launch_layout<false, 3>(p, layout, nt, smem, blocks, n_co, st);
}
