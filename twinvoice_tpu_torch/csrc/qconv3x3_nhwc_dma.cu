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
// tensor cores: bound by bytes, with the operations close behind, so the
// products have to run on the tensor cores at near their peak.
//
// Design: the DMA ring becomes a TMA ring (int8_tma_conv.cuh): a producer
// warp asks TMA for each tile's (tile_rows + 2) x 66 slab of the padded input,
// a chunk of channels at a time, into an mbarrier ring; two consumer
// warpgroups run the 9 taps as wgmma products straight from the slab (each
// tap is another start address of the operand descriptor), with the weights
// resident in shared memory, and the int8 tile leaves through a TMA store
// while the next tile's slabs land. No zero halo is written: the caller's
// padding is read as it lies, and TMA reads zeros only past the padded
// input's edge, for the ragged last tile's outputs that are not stored.
//
// C interface for ctypes: twv_qconv3x3_nhwc_dma checks the plan it is given,
// launches on the given stream and returns 0, a cudaError_t, or an error of
// the tensor-map encoder (int8_tma_conv.cuh).

#include "int8_tma_conv.cuh"

// x: (N, H+2, W+2, C) int8 contiguous; w: the packed weights of
// ops/nhwc_conv.py:pack_dma_weights for the plan; a, bias: (Co,) float32;
// out: (N, H, W, Co) int8 contiguous; all on the device. out_inv =
// float32(127) / float32(out_scale); relu != 0 applies a ReLU. The plan:
// cot, chunk, stages, resident, tma_in, tma_out, smem, blocks
// (ops/nhwc_conv.py:dma_plan).
extern "C" int twv_qconv3x3_nhwc_dma(const void* x, const void* w, const void* a,
                                     const void* bias, int N, int H, int W, int C, int Co,
                                     int cot, int chunk, int stages, int resident, int tma_in,
                                     int tma_out, int smem, int blocks, float out_inv, int relu,
                                     void* out, void* stream) {
  twv_tma::Args p{};
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.a = static_cast<const float*>(a);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<int8_t*>(out);
  p.N = N;
  p.Hin = H + 2;
  p.Himg = H + 2;
  p.Win = W + 2;
  p.C = C;
  p.H = H;
  p.W = W;
  p.Co = Co;
  p.row_off = 0;
  p.col_off = 0;
  p.zero_pad = false;
  p.inv = out_inv;
  p.relu = relu;
  return twv_tma::launch<3>(p, cot, chunk, stages, resident, tma_in, tma_out, smem, blocks,
                            static_cast<cudaStream_t>(stream));
}
