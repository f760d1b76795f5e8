// The int8 tensor-core convolution over a 3 x KW window shared by K4a/K5
// (csrc/qconv3x3.cu, KW = 3: the 3x3 SAME conv of NHWC tensors) and K7b
// (csrc/qconv3x3_pair.cu, KW = 2: the pair-packed conv, three rows times two
// pair views). Each source holds its kernel's contract, bound and design note;
// this header holds the implicit GEMM they share, on mma.sync m16n8k32 s8
// (int8_mma_conv.cuh):
//   out[n, h, w, co] = epilogue(sum_{dy < 3, dx < KW, c < Cin}
//                               x[n, h + dy - 1, w + dx - pad_w, c] * wt[co, dy, dx, c])
// with rows and columns outside x read as zeros. x is (N, H, Win, Cin) int8
// contiguous, the weights (Co, 3, KW, Cin) int8 contiguous, out (N, H, W, Co)
// int8 contiguous; K4a has Win = W and pad_w = 1, K7b Win = P and pad_w = 0
// (phase A input) or 1 (phase B).
//
// A block owns 8 * NT output channels and walks output tiles of tile_rows(NT)
// x 32 pixels over the batch (a persistent grid). Per tile it walks "items":
// Cin in chunks of cc channels (and for K5 the chunks of a second input). Each
// item's (rows + 2) x (32 + 2) halo slab lands in a cp.async ring in shared
// memory; the s32 sums stay in registers across the items of a tile. The
// weights are staged in the slab's k order, zeros in the padding slots, once
// for the block's life when a tile has no more items than the ring has slots,
// else through the ring beside the slab. Three k layouts keep narrow inputs
// from feeding the tensor cores zeros:
//   kStem (Cin <= 4)   eight taps of 4 channels a 32-byte k step (3 KW / 8
//                      steps, rounded up); A loaded with lds.32, the slab
//                      through registers two items ahead (3-byte pixels are
//                      too narrow for cp.async).
//   kPair (Cin <= 16)  two taps of 16 channels a k step (a0/a1 tap t, a2/a3
//                      tap t + 1).
//   kWide (Cin > 16)   32 channels of one tap a k step, cc = 32, 64 or 128.
// The int8 results go through shared memory and out as whole 16-byte rows
// when Co % 16 == 0 and the pointer is aligned, byte by byte otherwise.
#pragma once

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "int8_conv_common.cuh"
#include "int8_mma_conv.cuh"

namespace twv_window {

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

// 32-byte k steps of one chunk's taps: 8 taps a step (kStem), 2 (kPair), or
// cc / 32 a tap (kWide).
__host__ __device__ constexpr int k_steps(int layout, int cc, int kw) {
  return layout == kStem ? (3 * kw + 7) / 8
         : layout == kPair ? (3 * kw + 1) / 2
                           : 3 * kw * cc / 32;
}

// Bytes of a slab pixel, of one output channel's weight row (a chunk), and of
// an output pixel in the staging area: odd numbers of 16-byte granules (the
// stem's 4-byte pixel aside).
__host__ __device__ constexpr int slab_pixel_bytes(int layout, int cc) {
  return layout == kStem ? 4 : layout == kPair ? 16 : twv::pixel_bytes(cc);
}
__host__ __device__ constexpr int weight_row_bytes(int layout, int cc, int kw) {
  return twv::pixel_bytes(32 * k_steps(layout, cc, kw));
}

struct Args {
  const int8_t* x[2];  // (N, H, Win, Cin) int8 contiguous; [1] K5's second input
  const int8_t* w[2];  // (Co, 3, KW, Cin) int8 contiguous
  const float* w_scale;
  const float* bias;
  int H, W, Win, pad_w, Cin, Co;   // output width W; input width Win, read from column -pad_w
  int cc, lg16, n_chunks, items;  // chunk channels (16 << lg16); chunks an input; items a tile
  int stages;                      // slots of the ring
  int th, n_th, n_tw, tiles;       // output rows of a tile; tiles down, across, in all
  int sa, wb, ob;                         // slab pixel, weight row, output pixel bytes
  int slab_bytes, wchunk_bytes;           // one ring slot; one item's weights
  bool vec_x, vec_w, vec_out, resident;
  bool zero_pad;  // K7b B->A: column 0's lower and column W-1's upper half of Co written as 0
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

// Top-left output pixel (row h0, column w0) of a tile, and its image.
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

// The stem's slab pixel word: channels 0..3, zero outside the input and past Cin.
__device__ __forceinline__ int stem_word(const Args& p, const int8_t* img, int h, int wc) {
  if (h < 0 || h >= p.H || wc < 0 || wc >= p.Win) return 0;
  const int8_t* px = img + (static_cast<long long>(h) * p.Win + wc) * p.Cin;
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
  const int8_t* img = p.x[it.half] + static_cast<long long>(n) * p.H * p.Win * p.Cin;
#pragma unroll
  for (int k = 0; k < kStemWords<NT>; ++k) {
    const int i = threadIdx.x + k * kThreads;
    v[k] = i < kPix ? stem_word(p, img, h0 - 1 + i / kPW, w0 - p.pad_w + i % kPW) : 0;
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
  const int8_t* img = p.x[it.half] + static_cast<long long>(n) * p.H * p.Win * p.Cin;
  const int lg = p.lg16;  // cc / 16 = 2^lg granules a pixel
  const int c0 = it.chunk * p.cc;
  for (int i = threadIdx.x; i < kPix << lg; i += kThreads) {
    const int px = i >> lg;
    const int c = c0 + 16 * (i & ((1 << lg) - 1));
    const int h = h0 - 1 + px / kPW;
    const int wc = w0 - p.pad_w + px % kPW;
    const bool inside = h >= 0 && h < p.H && wc >= 0 && wc < p.Win;
    const int8_t* src = img + (static_cast<long long>(h) * p.Win + wc) * p.Cin;
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
template <int L, int CoT, int KW>
__device__ void stage_weights(const Args& p, uint8_t* dst, int co0, int half, int chunk) {
  constexpr int kTaps = 3 * KW;
  const int8_t* w = p.w[half];
  if (L == kStem) {  // tap t's channels at bytes 4t..4t+3, later slots zero
    constexpr int kSlots = 8 * k_steps(kStem, 4, KW);
    for (int i = threadIdx.x; i < CoT * kSlots; i += kThreads) {
      const int co = i / kSlots;
      const int t = i % kSlots;
      int v = 0;
      if (t < kTaps && co0 + co < p.Co) {
        v = twv::load_word(w + (static_cast<long long>(co0 + co) * kTaps + t) * p.Cin, 0,
                           p.Cin);
      }
      *reinterpret_cast<int*>(dst + co * p.wb + 4 * t) = v;
    }
    return;
  }
  // kPair: tap t's channels at bytes 16t..16t+15, the slot past the last tap
  // zero; kWide: tap t's chunk channels at bytes t*cc..t*cc+cc-1
  const int per_tap = L == kPair ? 1 : p.cc / 16;
  const int g16 = L == kPair ? 2 * k_steps(kPair, 16, KW) : kTaps * per_tap;
  const int c0 = chunk * p.cc;
  for (int i = threadIdx.x; i < CoT * g16; i += kThreads) {
    const int co = i / g16;
    const int k = i - co * g16;
    const int t = k / per_tap;
    const int c = c0 + 16 * (k - t * per_tap);
    const bool ok = co0 + co < p.Co && t < kTaps && c < p.Cin;
    const int8_t* src = w + (static_cast<long long>(co0 + co) * kTaps + t) * p.Cin;
    uint8_t* d = dst + co * p.wb + 16 * k;
    if (p.vec_w) {
      twv::cp_async16(d, ok ? src + c : w, ok ? 16 : 0);
    } else {
      *reinterpret_cast<int4*>(d) = ok ? load16(src, c, p.Cin) : make_int4(0, 0, 0, 0);
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void mma_step(int (&acc)[MT][NT][4], const int (&a)[MT][4],
                                         unsigned wsm, int wb, int kb, int lane) {
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    int b[4];
    twv::load_b<NT>(b, wsm, wb, j, kb, lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      twv::mma_s8(acc[mt][j], a[mt], b[0], b[1]);
      if constexpr (NT > 1) twv::mma_s8(acc[mt][j + 1], a[mt], b[2], b[3]);
    }
  }
}

// The products of one item (slab s, weights wt) added to acc by warp `warp`:
// m tile mt covers output row warp * MT / 2 + mt / 2 of the tile, columns
// 16 (mt % 2) .. 16 (mt % 2) + 15. Tap t is window row t / KW, column t % KW.
template <int L, int NT, int KW>
__device__ __forceinline__ void mma_item(int (&acc)[m_tiles(NT)][NT][4], const Args& p,
                                         const uint8_t* s, const uint8_t* wt, int warp,
                                         int lane) {
  constexpr int MT = m_tiles(NT);
  constexpr int kTaps = 3 * KW;
  const unsigned wsm = twv::smem_addr(wt);
  const int row0 = warp * (MT / 2);
  if (L == kStem) {
    // lane (g, q): a0/a1 tap 8k + q of pixels g, g + 8; a2/a3 tap 8k + 4 + q
    const int g = lane >> 2;
    const int q = lane & 3;
    const int* sw = reinterpret_cast<const int*>(s);
#pragma unroll
    for (int k = 0; k < k_steps(kStem, 4, KW); ++k) {
      int a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = 8 * k + 4 * (r >> 1) + q;
          const int px = (row0 + mt / 2 + t / KW) * kPW + (mt & 1) * 16 + g + 8 * (r & 1) +
                         t % KW;
          a[mt][r] = t < kTaps ? sw[px] : 0;
        }
      }
      mma_step<MT, NT>(acc, a, wsm, p.wb, 32 * k, lane);
    }
    return;
  }
  const unsigned ss = twv::smem_addr(s);
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1);  // pixel of the m tile
  if (L == kPair) {
    // lanes 0-15: tap 2k at k bytes 0-15; lanes 16-31: tap 2k + 1 at 16-31 (a
    // tap past the last has zero weights)
#pragma unroll
    for (int k = 0; k < k_steps(kPair, 16, KW); ++k) {
      const int t = min(2 * k + (lane >> 4), kTaps - 1);
      const unsigned base = ss + ((row0 + t / KW) * kPW + arow + t % KW) * 16;
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
  for (int t = 0; t < kTaps; ++t) {
    const unsigned base = ss + ((row0 + t / KW) * kPW + arow + t % KW) * p.sa + akb;
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
  // ReLU as a floor (-inf: none), and the clip split around the round, both
  // bounds being integers: max(v, lo) before it, then __float2int_rn (half to
  // even, as rintf) and cvt.pack.sat's saturation at 127
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
        int v[2];
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
          v[e] = __float2int_rn(fmaxf(__fmul_rn(fmaxf(y, relu_floor), p.inv), lo));
        }
        const int px = (warp * (MT / 2) + mt / 2) * kTW + (mt & 1) * 16 + g + 8 * hf;
        *reinterpret_cast<uint16_t*>(osm + px * p.ob + j * 8 + 2 * q) =
            static_cast<uint16_t>(twv::pack2_s8(v[0], v[1]));
      }
    }
  }
}

// K7b B->A: output byte co of column wc is the baked-in W pad (written as 0):
// the lower half of Co at column 0, the upper half at column W - 1.
__device__ __forceinline__ bool pad_byte(const Args& p, int wc, int co) {
  return p.zero_pad && ((wc == 0 && co < p.Co / 2) || (wc == p.W - 1 && co >= p.Co / 2));
}

// The tile's staged outputs to device memory: whole 16-byte rows, or bytes;
// the pad bytes of a B->A output as zeros.
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
        int4 v = *reinterpret_cast<const int4*>(osm + px * p.ob + 16 * k);
        if (p.zero_pad && (wc == 0 || wc == p.W - 1)) {
          int w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            if (pad_byte(p, wc, co + e)) w4[e / 4] &= ~(0xff << (8 * (e % 4)));
          }
          v = make_int4(w4[0], w4[1], w4[2], w4[3]);
        }
        *reinterpret_cast<int4*>(p.out + ((static_cast<long long>(n) * p.H + h) * p.W + wc) *
                                             p.Co + co) = v;
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
            pad_byte(p, wc, co0 + j) ? 0 : static_cast<int8_t>(osm[px * p.ob + j]);
      }
    }
  }
}

template <int L, int NT, bool SEP, int KW>
__global__ void __launch_bounds__(kThreads, min_blocks(NT, SEP)) window_conv_kernel(Args p) {
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
      stage_weights<L, CoT, KW>(p, wsm + j % S * p.wchunk_bytes, co0, it.half, it.chunk);
    }
  };
  // the weights (all of them when resident) join item 0's group; items
  // 0..S-2 are in flight before the loop, one group each
  if (p.resident) {
    for (int i = 0; i < p.items; ++i) {
      stage_weights<L, CoT, KW>(p, wsm + i * p.wchunk_bytes, co0, i / p.n_chunks,
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
    twv::wait_oldest(S);  // item i's slab (and weights) have landed
    __syncthreads();

    const uint8_t* s = slab + i % S * p.slab_bytes;
    const uint8_t* wt =
        wsm + (p.resident ? cur.half * p.n_chunks + cur.chunk : i % S) * p.wchunk_bytes;
    if (SEP && cur.half) {
      mma_item<L, NT, KW>(acc2, p, s, wt, warp, lane);
    } else {
      mma_item<L, NT, KW>(acc, p, s, wt, warp, lane);
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

template <int L, int NT, bool SEP, int KW>
int launch(const Args& p, int smem, int blocks, int n_co, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(window_conv_kernel<L, NT, SEP, KW>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  window_conv_kernel<L, NT, SEP, KW><<<dim3(blocks, n_co), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int L, bool SEP, int KW>
int launch_nt(const Args& p, int nt, int smem, int blocks, int n_co, cudaStream_t st) {
  switch (nt) {
    case 1: return launch<L, 1, SEP, KW>(p, smem, blocks, n_co, st);
    case 2: return launch<L, 2, SEP, KW>(p, smem, blocks, n_co, st);
    case 4: return launch<L, SEP ? 2 : 4, SEP, KW>(p, smem, blocks, n_co, st);
    default: return launch<L, SEP ? 2 : 8, SEP, KW>(p, smem, blocks, n_co, st);
  }
}

template <bool SEP, int KW>
int launch_layout(const Args& p, int layout, int nt, int smem, int blocks, int n_co,
                  cudaStream_t st) {
  switch (layout) {
    case kStem: return launch_nt<kStem, SEP, KW>(p, nt, smem, blocks, n_co, st);
    case kPair: return launch_nt<kPair, SEP, KW>(p, nt, smem, blocks, n_co, st);
    default: return launch_nt<kWide, SEP, KW>(p, nt, smem, blocks, n_co, st);
  }
}

// Checks the plan (layout, chunk, n tiles, ring slots, shared-memory bytes,
// blocks; computed by ops/qconv.py:conv_plan) against the shape and fills the
// plan's part of p (p.H, p.W, p.Win, p.Cin, p.Co and the pointers are set by
// the caller). halves: 2 for K5's two inputs. → 0, or cudaErrorInvalidValue.
template <int KW>
int plan_args(Args& p, int N, int halves, bool sep, int layout, int cc, int nt, int stages,
              int smem, int blocks) {
  const bool layout_ok = (layout == kStem && p.Cin <= 4 && cc == 4) ||
                         (layout == kPair && p.Cin <= 16 && cc == 16) ||
                         (layout == kWide && (cc == 32 || cc == 64 || cc == 128));
  if (N < 1 || p.H < 1 || p.W < 1 || p.Win < 1 || p.Cin < 1 || p.Co < 1 || !layout_ok ||
      (nt != 1 && nt != 2 && nt != 4 && nt != 8) || (sep && nt > 2) || stages < 2 ||
      stages > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_co = (p.Co + 8 * nt - 1) / (8 * nt);
  const int th = tile_rows(nt);
  const long long tiles =
      static_cast<long long>(N) * ((p.H + th - 1) / th) * ((p.W + kTW - 1) / kTW);
  const int n_chunks = (p.Cin + cc - 1) / cc;
  const int items = halves * n_chunks;
  p.sa = slab_pixel_bytes(layout, cc);
  p.wb = weight_row_bytes(layout, cc, KW);
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
  p.cc = cc;
  p.lg16 = cc >= 128 ? 3 : cc >= 64 ? 2 : cc >= 32 ? 1 : 0;
  p.n_chunks = n_chunks;
  p.items = items;
  p.stages = stages;
  p.th = th;
  p.n_th = (p.H + th - 1) / th;
  p.n_tw = (p.W + kTW - 1) / kTW;
  p.tiles = static_cast<int>(tiles);
  const int xa = layout == kStem ? 4 : 16;
  p.vec_x = (layout == kStem ? p.Cin == 4 : p.Cin % 16 == 0) && twv::aligned(p.x[0], xa) &&
            twv::aligned(p.x[1], xa);
  p.vec_w = layout != kStem && p.Cin % 16 == 0 && twv::aligned(p.w[0], 16) &&
            twv::aligned(p.w[1], 16);
  p.vec_out = p.Co % 16 == 0 && nt >= 2 && twv::aligned(p.out, 16);
  p.resident = items <= stages;
  return 0;
}

}  // namespace twv_window
