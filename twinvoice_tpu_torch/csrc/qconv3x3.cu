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
// C interface for ctypes: twv_qconv3x3_requant checks the plan it is given
// (layout, chunk, Co tile, shared-memory bytes, grid; computed by
// ops/qconv.py:conv_plan), launches on the given stream and returns
// cudaGetLastError() as an int (0 = launched).

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "int8_conv_common.cuh"
#include "int8_mma_conv.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTW = 32;  // output columns of a tile: two m tiles of 16 pixels
constexpr int kPW = kTW + 2;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

// A warp computes MT m tiles of 16 pixels (MT / 2 output rows) by NT n tiles
// of 8 output channels: MT = 4 up to 32 output channels a block, whose blocks
// would otherwise do little work between two barriers, else 2 (MT x NT x 4
// s32 sums a thread).
__host__ __device__ constexpr int m_tiles(int nt) { return nt <= 4 ? 4 : 2; }
__host__ __device__ constexpr int tile_rows(int nt) { return kWarps * m_tiles(nt) / 2; }
__host__ __device__ constexpr int slab_pixels(int nt) { return (tile_rows(nt) + 2) * kPW; }
// Blocks an SM: __launch_bounds__ caps the registers so that they fit (85 a
// thread for three, 128 for two; two s32 tiles need two).
__host__ __device__ constexpr int min_blocks(int nt, bool sep) {
  return nt <= 2 && !sep ? 3 : 2;
}

enum Layout { kStem = 0, kPair = 1, kWide = 2 };
enum Mode { kProd = 0, kChain = 1, kSeparate = 2 };

// Bytes of a slab pixel, of one output channel's weight row (a chunk), and of
// an output pixel in the staging area: odd numbers of 16-byte granules (the
// stem's 4-byte pixel aside).
__host__ __device__ constexpr int slab_pixel_bytes(int layout, int cc) {
  return layout == kStem ? 4 : layout == kPair ? 16 : twv::pixel_bytes(cc);
}
__host__ __device__ constexpr int weight_row_bytes(int layout, int cc) {
  return layout == kStem ? twv::pixel_bytes(64)
         : layout == kPair ? twv::pixel_bytes(160)
                           : twv::pixel_bytes(9 * cc);
}

struct Args {
  const int8_t* x[2];  // (N, H, W, Cin) int8 contiguous; [1] K5's second input
  const int8_t* w[2];  // (Co, 3, 3, Cin) int8 contiguous
  const float* w_scale;
  const float* bias;
  int H, W, Cin, Co;
  int cc, lg16, n_chunks, items;  // chunk channels (16 << lg16); chunks an input; items a tile
  int stages;                      // slots of the ring
  int th, n_th, n_tw, tiles;       // output rows of a tile; tiles down, across, in all
  int sa, wb, ob;                         // slab pixel, weight row, output pixel bytes
  int slab_bytes, wchunk_bytes;           // one ring slot; one item's weights
  bool vec_x, vec_w, vec_out, resident;
  float s0, s1, inv;
  int mode, relu;
  int8_t* out;  // (N, H, W, Co) int8 contiguous
};

struct Item {
  int tile, half, chunk;
};

// Item i of this block: tile blockIdx.x + (i / items) * gridDim.x; within a
// tile the chunks of input 0, then those of input 1.
__device__ __forceinline__ Item item_at(const Args& p, int i) {
  if (p.items == 1) return {static_cast<int>(blockIdx.x) + i * static_cast<int>(gridDim.x), 0, 0};
  const int r = i % p.items;
  return {static_cast<int>(blockIdx.x) + i / p.items * static_cast<int>(gridDim.x),
          r / p.n_chunks, r % p.n_chunks};
}

// Top-left input pixel (row h0, column w0, both - 1 for the halo) of a tile,
// and its image.
__device__ __forceinline__ void tile_origin(const Args& p, int tile, int& n, int& h0,
                                            int& w0) {
  n = tile / (p.n_th * p.n_tw);
  const int r = tile - n * (p.n_th * p.n_tw);
  h0 = r / p.n_tw * p.th;
  w0 = r % p.n_tw * kTW;
}

// 16 bytes of channels c..c+15 of the pixel at px (zero past Cin), by bytes.
__device__ __forceinline__ int4 load16(const int8_t* px, int c, int C) {
  return make_int4(twv::load_word(px, c, C), twv::load_word(px, c + 4, C),
                   twv::load_word(px, c + 8, C), twv::load_word(px, c + 12, C));
}

// The stem's slab pixel word: channels 0..3, zero outside the image and past Cin.
__device__ __forceinline__ int stem_word(const Args& p, const int8_t* img, int h, int wc) {
  if (h < 0 || h >= p.H || wc < 0 || wc >= p.W) return 0;
  const int8_t* px = img + (static_cast<long long>(h) * p.W + wc) * p.Cin;
  return p.vec_x ? *reinterpret_cast<const int*>(px) : twv::load_word(px, 0, p.Cin);
}

template <int NT>
constexpr int kStemWords = (slab_pixels(NT) + kThreads - 1) / kThreads;

// The stem's slab goes through registers, loaded two items ahead (its pixels
// are 3 bytes, too narrow for cp.async).
template <int NT>
__device__ __forceinline__ void load_stem(const Args& p, const Item& it, int* v) {
  constexpr int kPix = slab_pixels(NT);
  int n, h0, w0;
  tile_origin(p, it.tile, n, h0, w0);
  const int8_t* img = p.x[it.half] + static_cast<long long>(n) * p.H * p.W * p.Cin;
#pragma unroll
  for (int k = 0; k < kStemWords<NT>; ++k) {
    const int i = threadIdx.x + k * kThreads;
    v[k] = i < kPix ? stem_word(p, img, h0 - 1 + i / kPW, w0 - 1 + i % kPW) : 0;
  }
}

template <int NT>
__device__ __forceinline__ void store_stem(uint8_t* dst, const int* v) {
  constexpr int kPix = slab_pixels(NT);
#pragma unroll
  for (int k = 0; k < kStemWords<NT>; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < kPix) reinterpret_cast<int*>(dst)[i] = v[k];
  }
}

// The slab of item `it` (kPair, kWide): 16-byte granules by cp.async where
// the input allows it, else by bytes.
template <int NT>
__device__ void stage_slab(const Args& p, uint8_t* dst, const Item& it) {
  constexpr int kPix = slab_pixels(NT);
  int n, h0, w0;
  tile_origin(p, it.tile, n, h0, w0);
  const int8_t* img = p.x[it.half] + static_cast<long long>(n) * p.H * p.W * p.Cin;
  const int lg = p.lg16;  // cc / 16 = 2^lg granules a pixel
  const int c0 = it.chunk * p.cc;
  for (int i = threadIdx.x; i < kPix << lg; i += kThreads) {
    const int px = i >> lg;
    const int c = c0 + 16 * (i & ((1 << lg) - 1));
    const int h = h0 - 1 + px / kPW;
    const int wc = w0 - 1 + px % kPW;
    const bool inside = h >= 0 && h < p.H && wc >= 0 && wc < p.W;
    const int8_t* src = img + (static_cast<long long>(h) * p.W + wc) * p.Cin;
    uint8_t* d = dst + px * p.sa + (c - c0);
    if (p.vec_x) {
      const bool ok = inside && c < p.Cin;
      twv::cp_async16(d, ok ? src + c : p.x[0], ok ? 16 : 0);
    } else {
      *reinterpret_cast<int4*>(d) = inside ? load16(src, c, p.Cin) : make_int4(0, 0, 0, 0);
    }
  }
}

// One item's weights for the block's output channels, [co][k] in the
// layout's k order, zeros past Cin, past Co and in the padding taps.
template <int L, int CoT>
__device__ void stage_weights(const Args& p, uint8_t* dst, int co0, int half, int chunk) {
  const int8_t* w = p.w[half];
  if (L == kStem) {  // tap t's channels at bytes 4t..4t+3, taps 9..15 zero
    for (int i = threadIdx.x; i < CoT * 16; i += kThreads) {
      const int co = i / 16;
      const int t = i % 16;
      int v = 0;
      if (t < 9 && co0 + co < p.Co) {
        v = twv::load_word(w + (static_cast<long long>(co0 + co) * 9 + t) * p.Cin, 0, p.Cin);
      }
      *reinterpret_cast<int*>(dst + co * p.wb + 4 * t) = v;
    }
    return;
  }
  // kPair: tap t's channels at bytes 16t..16t+15, slot 9 zero; kWide: tap t's
  // chunk channels at bytes t*cc..t*cc+cc-1
  const int per_tap = L == kPair ? 1 : p.cc / 16;
  const int g16 = L == kPair ? 10 : 9 * per_tap;
  const int c0 = chunk * p.cc;
  for (int i = threadIdx.x; i < CoT * g16; i += kThreads) {
    const int co = i / g16;
    const int k = i - co * g16;
    const int t = k / per_tap;
    const int c = c0 + 16 * (k - t * per_tap);
    const bool ok = co0 + co < p.Co && t < 9 && c < p.Cin;
    const int8_t* src = w + (static_cast<long long>(co0 + co) * 9 + t) * p.Cin;
    uint8_t* d = dst + co * p.wb + 16 * k;
    if (p.vec_w) {
      twv::cp_async16(d, ok ? src + c : w, ok ? 16 : 0);
    } else {
      *reinterpret_cast<int4*>(d) = ok ? load16(src, c, p.Cin) : make_int4(0, 0, 0, 0);
    }
  }
}

// B fragments of n tiles j and j + 1 (or j alone when NT == 1) at k byte kb of
// the weight rows: b[0], b[1] for tile j, b[2], b[3] for tile j + 1.
template <int NT>
__device__ __forceinline__ void load_b(int* b, unsigned wsm, int wb, int j, int kb, int lane) {
  const int row = j * 8 + (NT == 1 ? 0 : (lane >> 4) * 8) + (lane & 7);
  const unsigned addr = wsm + row * wb + kb + 16 * ((lane >> 3) & 1);
  if (NT == 1) {
    twv::ldsm_x2(b, addr);
  } else {
    twv::ldsm_x4(b, addr);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void mma_step(int (&acc)[MT][NT][4], const int (&a)[MT][4],
                                         unsigned wsm, int wb, int kb, int lane) {
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    int b[4];
    load_b<NT>(b, wsm, wb, j, kb, lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      twv::mma_s8(acc[mt][j], a[mt], b[0], b[1]);
      if constexpr (NT > 1) twv::mma_s8(acc[mt][j + 1], a[mt], b[2], b[3]);
    }
  }
}

// The products of one item (slab s, weights wt) added to acc by warp `warp`:
// m tile mt covers output row warp * MT / 2 + mt / 2 of the tile, columns
// 16 (mt % 2) .. 16 (mt % 2) + 15.
template <int L, int NT>
__device__ __forceinline__ void mma_item(int (&acc)[m_tiles(NT)][NT][4], const Args& p,
                                         const uint8_t* s, const uint8_t* wt, int warp,
                                         int lane) {
  constexpr int MT = m_tiles(NT);
  const unsigned wsm = twv::smem_addr(wt);
  const int row0 = warp * (MT / 2);
  if (L == kStem) {
    // lane (g, q): a0/a1 tap 8k + q of pixels g, g + 8; a2/a3 tap 8k + 4 + q
    const int g = lane >> 2;
    const int q = lane & 3;
    const int* sw = reinterpret_cast<const int*>(s);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      int a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = 8 * k + 4 * (r >> 1) + q;
          const int px = (row0 + mt / 2 + t / 3) * kPW + (mt & 1) * 16 + g + 8 * (r & 1) + t % 3;
          a[mt][r] = t < 9 ? sw[px] : 0;
        }
      }
      mma_step<MT, NT>(acc, a, wsm, p.wb, 32 * k, lane);
    }
    return;
  }
  const unsigned ss = twv::smem_addr(s);
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1);  // pixel of the m tile
  if (L == kPair) {
    // lanes 0-15: tap 2k at k bytes 0-15; lanes 16-31: tap 2k + 1 at 16-31
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int t = min(2 * k + (lane >> 4), 8);  // tap 9 has zero weights
      const unsigned base = ss + ((row0 + t / 3) * kPW + arow + t % 3) * 16;
      int a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        twv::ldsm_x4(a[mt], base + ((mt / 2) * kPW + (mt & 1) * 16) * 16);
      }
      mma_step<MT, NT>(acc, a, wsm, p.wb, 32 * k, lane);
    }
    return;
  }
  const int akb = 16 * (lane >> 4);
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const unsigned base = ss + ((row0 + t / 3) * kPW + arow + t % 3) * p.sa + akb;
    for (int c = 0; c < p.cc; c += 32) {
      int a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        twv::ldsm_x4(a[mt], base + ((mt / 2) * kPW + (mt & 1) * 16) * p.sa + c);
      }
      mma_step<MT, NT>(acc, a, wsm, p.wb, t * p.cc + c, lane);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(int (&acc)[m_tiles(NT)][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < m_tiles(NT); ++mt) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][j][r] = 0;
    }
  }
}

// The requantised int8 outputs of warp `warp`'s pixels into the staging area
// [pixel][co], two neighbouring channels a 16-bit store.
template <int NT, bool SEP>
__device__ __forceinline__ void epilogue(const Args& p, const int (&acc)[m_tiles(NT)][NT][4],
                                         const int (&acc2)[m_tiles(NT)][NT][4], uint8_t* osm,
                                         int co0, int warp, int lane) {
  constexpr int MT = m_tiles(NT);
  const int g = lane >> 2;
  const int q = lane & 3;
  // ReLU as a floor (-inf: none), and the clip before the round: the bounds
  // are integers, so clip(rint(v)) == rint(clip(v)) (__float2int_rn rounds
  // half to even, as rintf)
  const float relu_floor = p.relu ? 0.0f : -INFINITY;
  const float lo = p.relu ? 0.0f : -127.0f;
  const bool chain = p.mode == kChain;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float ws[2], b[2], a[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co0 + j * 8 + 2 * q + e;
      ws[e] = co < p.Co ? __ldg(p.w_scale + co) : 0.0f;
      b[e] = co < p.Co ? __ldg(p.bias + co) : 0.0f;
      a[e] = __fmul_rn(p.s0, ws[e]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        unsigned pair = 0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 2 * hf + e;
          const float f = __int2float_rn(acc[mt][j][r]);
          float y;
          if (SEP) {
            const float p2 = __fmul_rn(__int2float_rn(acc2[mt][j][r]), p.s1);
            y = __fmaf_rn(__fmaf_rn(f, p.s0, p2), ws[e], b[e]);
          } else {
            y = chain ? __fmaf_rn(__fmul_rn(f, p.s0), ws[e], b[e]) : __fmaf_rn(f, a[e], b[e]);
          }
          const float v = fminf(fmaxf(__fmul_rn(fmaxf(y, relu_floor), p.inv), lo), 127.0f);
          pair |= (static_cast<unsigned>(__float2int_rn(v)) & 0xffu) << (8 * e);
        }
        const int px = (warp * (MT / 2) + mt / 2) * kTW + (mt & 1) * 16 + g + 8 * hf;
        *reinterpret_cast<uint16_t*>(osm + px * p.ob + j * 8 + 2 * q) =
            static_cast<uint16_t>(pair);
      }
    }
  }
}

// The tile's staged outputs to device memory: whole 16-byte rows, or bytes.
template <int NT>
__device__ __forceinline__ void store_tile(const Args& p, const uint8_t* osm, int tile,
                                           int co0) {
  constexpr int CoT = 8 * NT;
  constexpr int kOut = tile_rows(NT) * kTW;  // pixels of a tile
  int n, h0, w0;
  tile_origin(p, tile, n, h0, w0);
  if (p.vec_out) {
    constexpr int G = CoT / 16;
    for (int i = threadIdx.x; i < kOut * G; i += kThreads) {
      const int px = i / G;
      const int k = i - px * G;
      const int h = h0 + px / kTW;
      const int wc = w0 + px % kTW;
      const int co = co0 + 16 * k;
      if (h < p.H && wc < p.W && co < p.Co) {
        *reinterpret_cast<int4*>(p.out + ((static_cast<long long>(n) * p.H + h) * p.W + wc) *
                                             p.Co + co) =
            *reinterpret_cast<const int4*>(osm + px * p.ob + 16 * k);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kOut * CoT; i += kThreads) {
      const int px = i / CoT;
      const int j = i - px * CoT;
      const int h = h0 + px / kTW;
      const int wc = w0 + px % kTW;
      if (h < p.H && wc < p.W && co0 + j < p.Co) {
        p.out[((static_cast<long long>(n) * p.H + h) * p.W + wc) * p.Co + co0 + j] =
            static_cast<int8_t>(osm[px * p.ob + j]);
      }
    }
  }
}

// Waits until at most stages - 1 of this thread's cp.async groups are in
// flight: of the items i .. i + stages - 1 in flight, item i has landed.
__device__ __forceinline__ void wait_oldest(int stages) {
  if (stages == 2) {
    twv::cp_async_wait<1>();
  } else if (stages == 3) {
    twv::cp_async_wait<2>();
  } else {
    twv::cp_async_wait<3>();
  }
}

template <int L, int NT, bool SEP>
__global__ void __launch_bounds__(kThreads, min_blocks(NT, SEP)) qconv3x3_kernel(Args p) {
  constexpr int CoT = 8 * NT;
  constexpr int MT = m_tiles(NT);
  extern __shared__ __align__(16) uint8_t smem[];
  const int S = p.stages;
  uint8_t* slab = smem;
  uint8_t* wsm = smem + S * p.slab_bytes;
  uint8_t* osm = wsm + min(p.items, S) * p.wchunk_bytes;
  const int co0 = blockIdx.y * CoT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // Item j's slab (and its weights, when they ride in the ring) into its slot;
  // the stem's slab was loaded into registers two items ahead instead.
  auto stage = [&](int j) {
    const Item it = item_at(p, j);
    if (it.tile >= p.tiles) return;
    if (L != kStem) stage_slab<NT>(p, slab + j % S * p.slab_bytes, it);
    if (!p.resident) {
      stage_weights<L, CoT>(p, wsm + j % S * p.wchunk_bytes, co0, it.half, it.chunk);
    }
  };
  // the weights (all of them when resident) join item 0's group; items
  // 0..S-2 are in flight before the loop, one group each
  if (p.resident) {
    for (int i = 0; i < p.items; ++i) {
      stage_weights<L, CoT>(p, wsm + i * p.wchunk_bytes, co0, i / p.n_chunks,
                            i % p.n_chunks);
    }
  }
  for (int j = 0; j < S - 1; ++j) {
    stage(j);
    twv::cp_async_commit();
  }
  int sv[2][kStemWords<NT>];
  if (L == kStem) {
    load_stem<NT>(p, item_at(p, 0), sv[0]);
    store_stem<NT>(slab, sv[0]);
    if (item_at(p, 1).tile < p.tiles) load_stem<NT>(p, item_at(p, 1), sv[1]);
  }

  int acc[MT][NT][4];
  int acc2[MT][NT][4];
  zero<NT>(acc);
  zero<NT>(acc2);
  // Item i. `ahead` receives item i + 2's stem slab; `behind` holds item
  // i + 1's, stored once item i is computed. Two calls a round, so that the
  // register sets are named at compile time.
  auto step = [&](int i, int (&ahead)[kStemWords<NT>], const int (&behind)[kStemWords<NT>]) {
    const Item cur = item_at(p, i);
    if (cur.tile >= p.tiles) return false;
    stage(i + S - 1);
    twv::cp_async_commit();
    const bool more2 = L == kStem && item_at(p, i + 2).tile < p.tiles;
    if (more2) load_stem<NT>(p, item_at(p, i + 2), ahead);
    wait_oldest(S);  // item i's slab (and weights) have landed
    __syncthreads();

    const uint8_t* s = slab + i % S * p.slab_bytes;
    const uint8_t* wt =
        wsm + (p.resident ? cur.half * p.n_chunks + cur.chunk : i % S) * p.wchunk_bytes;
    if (SEP && cur.half) {
      mma_item<L, NT>(acc2, p, s, wt, warp, lane);
    } else {
      mma_item<L, NT>(acc, p, s, wt, warp, lane);
    }
    if (L == kStem && item_at(p, i + 1).tile < p.tiles) {
      store_stem<NT>(slab + (i + 1) % S * p.slab_bytes, behind);
    }
    const bool last = i % p.items == p.items - 1;
    if (last) epilogue<NT, SEP>(p, acc, acc2, osm, co0, warp, lane);
    __syncthreads();  // every warp is done with item i's slot, and osm is complete
    if (last) {
      store_tile<NT>(p, osm, cur.tile, co0);
      zero<NT>(acc);
      if (SEP) zero<NT>(acc2);
    }
    return true;
  };
  for (int i = 0; step(i, sv[0], sv[1]) && step(i + 1, sv[1], sv[0]); i += 2) {
  }
  twv::cp_async_wait<0>();
}

template <int L, int NT, bool SEP>
int launch(const Args& p, int smem, int blocks, int n_co, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(qconv3x3_kernel<L, NT, SEP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  qconv3x3_kernel<L, NT, SEP><<<dim3(blocks, n_co), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int L, bool SEP>
int launch_nt(const Args& p, int nt, int smem, int blocks, int n_co, cudaStream_t st) {
  switch (nt) {
    case 1: return launch<L, 1, SEP>(p, smem, blocks, n_co, st);
    case 2: return launch<L, 2, SEP>(p, smem, blocks, n_co, st);
    case 4: return launch<L, SEP ? 2 : 4, SEP>(p, smem, blocks, n_co, st);
    default: return launch<L, SEP ? 2 : 8, SEP>(p, smem, blocks, n_co, st);
  }
}

template <bool SEP>
int launch_layout(const Args& p, int layout, int nt, int smem, int blocks, int n_co,
                  cudaStream_t st) {
  switch (layout) {
    case kStem: return launch_nt<kStem, SEP>(p, nt, smem, blocks, n_co, st);
    case kPair: return launch_nt<kPair, SEP>(p, nt, smem, blocks, n_co, st);
    default: return launch_nt<kWide, SEP>(p, nt, smem, blocks, n_co, st);
  }
}

}  // namespace

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
  const bool sep = mode == kSeparate;
  const bool layout_ok = (layout == kStem && Cin <= 4 && cc == 4) ||
                         (layout == kPair && Cin <= 16 && cc == 16) ||
                         (layout == kWide && (cc == 32 || cc == 64 || cc == 128));
  if (N < 1 || H < 1 || W < 1 || Cin < 1 || Co < 1 || mode < kProd || mode > kSeparate ||
      (sep && !x2) || (!x2 != !w2) || !layout_ok ||
      (nt != 1 && nt != 2 && nt != 4 && nt != 8) || (sep && nt > 2) || stages < 2 ||
      stages > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_co = (Co + 8 * nt - 1) / (8 * nt);
  const int th = tile_rows(nt);
  const long long tiles =
      static_cast<long long>(N) * ((H + th - 1) / th) * ((W + kTW - 1) / kTW);
  const int n_chunks = (Cin + cc - 1) / cc;
  const int items = (x2 ? 2 : 1) * n_chunks;
  Args p;
  p.sa = slab_pixel_bytes(layout, cc);
  p.wb = weight_row_bytes(layout, cc);
  p.ob = twv::pixel_bytes(8 * nt);
  p.slab_bytes = slab_pixels(nt) * p.sa;
  p.wchunk_bytes = 8 * nt * p.wb;
  const long long need = static_cast<long long>(stages) * p.slab_bytes +
                         static_cast<long long>(items < stages ? items : stages) *
                             p.wchunk_bytes +
                         static_cast<long long>(th) * kTW * p.ob;
  if (n_co > 65535 || tiles > INT_MAX / 2 || need != smem || smem > kSmemLimit ||
      blocks < 1 || blocks > tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.x[0] = static_cast<const int8_t*>(x);
  p.x[1] = x2 ? static_cast<const int8_t*>(x2) : p.x[0];
  p.w[0] = static_cast<const int8_t*>(w);
  p.w[1] = w2 ? static_cast<const int8_t*>(w2) : p.w[0];
  p.w_scale = static_cast<const float*>(w_scale);
  p.bias = static_cast<const float*>(bias);
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Co = Co;
  p.cc = cc;
  p.lg16 = cc >= 128 ? 3 : cc >= 64 ? 2 : cc >= 32 ? 1 : 0;
  p.n_chunks = n_chunks;
  p.items = items;
  p.stages = stages;
  p.th = th;
  p.n_th = (H + th - 1) / th;
  p.n_tw = (W + kTW - 1) / kTW;
  p.tiles = static_cast<int>(tiles);
  const int xa = layout == kStem ? 4 : 16;
  p.vec_x = (layout == kStem ? Cin == 4 : Cin % 16 == 0) && twv::aligned(p.x[0], xa) &&
            twv::aligned(p.x[1], xa);
  p.vec_w = layout != kStem && Cin % 16 == 0 && twv::aligned(p.w[0], 16) &&
            twv::aligned(p.w[1], 16);
  p.vec_out = Co % 16 == 0 && nt >= 2 && twv::aligned(out, 16);
  p.resident = items <= stages;
  p.s0 = s0;
  p.s1 = s1;
  p.inv = out_inv;
  p.mode = mode;
  p.relu = relu;
  p.out = static_cast<int8_t*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return sep ? launch_layout<true>(p, layout, nt, smem, blocks, n_co, st)
             : launch_layout<false>(p, layout, nt, smem, blocks, n_co, st);
}
