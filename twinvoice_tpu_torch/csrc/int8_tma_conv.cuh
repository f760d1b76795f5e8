// The TMA-fed tensor-core convolution shared by four of the JAX package's
// Pallas kernels: K3a (csrc/qconv3x3_nhwc_dma.cu) and K3b
// (csrc/qconv3x3_nhwc_requant.cu), 3 x 3 windows over a caller-padded NHWC
// input, K4b (csrc/qconv3x3_requant_dma.cu), a 3 x 3 SAME window over an
// unpadded one, and K7a (csrc/qconv3x3_pair_dma.cu), a 3 x 2 window over a
// pair-packed input. Each source holds its kernel's contract and bound; this
// header holds the kernel they share:
//   acc[n, h, w, o] = sum_{dy < 3, dx < KW, c < C}
//                     x[n, h + dy + row_off, w + dx + col_off, c] * wt[o, dy, dx, c]
// with rows and columns outside x read as zeros; x holds N images of Hin
// visible rows of Win pixels of C int8 channels, contiguous within an image,
// the images Himg >= Hin rows apart (K3b sees only the rows between its
// padded input's H-pad rows); out is (N, H, W, Co) int8 contiguous;
//   y = fma(acc, a[o], bias[o])  (one rounding, as XLA fuses JAX's acc * a + b)
// then ReLU as a floor when asked and q = rint(y * inv) clipped to [0, 127]
// after a ReLU and to [-127, 127] without one. With zero_pad (K7a B->A) the
// lower half of Co at column 0 and the upper half at column W - 1 are
// written as zeros.
//
// The TPU kernels drive a two-slot ring of (th + 2)-row slabs by hand with
// make_async_copy and semaphores. Here the Tensor Memory Accelerator (TMA)
// is the copy engine and mbarriers are the semaphores. A block is three
// warpgroups: a producer (one working warp; setmaxnreg gives its registers to
// the others) and two consumers.
// - Producer: its lane 0 asks TMA for one box a ring item: the item's input
//   slab (tile_rows + 2 rows by 64 + KW - 1 columns, `chunk` channels, one
//   image) through a 5-D tensor map whose inner dimension is one 16-byte
//   granule of channels: (16 bytes, Win, Hin, C / 16, N), strides (C,
//   Win * C, 16, Himg * Win * C). The box lands as [granule][row][column][16
//   bytes], so every 8 neighbouring pixels of one granule are 128 contiguous
//   bytes: one core matrix of the wgmma operand layout without swizzle. The
//   box starts at row h0 + row_off and column w0 + col_off; TMA writes zeros
//   for whatever lies outside x (the zero H halo of K3b, K4b and K7a, K4b's W
//   halo, a B input's slab edges, the ragged last tile, the channels past
//   C). Each slot has a full and an
//   empty mbarrier; the producer waits on the slot's empty barrier, announces
//   the box's bytes on its full barrier (expect_tx) and starts the copy,
//   which completes it.
// - Where no tensor map is legal (C % 16 != 0, or x not 16-byte aligned),
//   the producer warp fills the same slot layout itself (zeros outside x and
//   past C), makes its writes visible to the tensor cores (fence.proxy.async)
//   and arrives on the same full barrier. The consumers cannot tell which
//   copy filled a slot.
// - Weights: packed by the caller as [co block][chunk][tap][granule][n][16
//   bytes] (each tap's k extent kb = max(chunk, 32) bytes, zeros past C and
//   Co), so that one chunk's weights for a block are one contiguous run, also
//   laid out in core matrices. They are resident (one bulk TMA copy at the
//   start) when all of them fit beside the ring, else each item's chunk rides
//   in its ring slot behind the slab, copied by a bulk TMA on the same full
//   barrier.
// - Consumers: wgmma.mma_async m64nNk32 s8 x s8 -> s32, N = CoT, the block's
//   output channels (32, 64 or 128). A tile is tile_rows x 64 output pixels;
//   each warpgroup owns tile_rows / 2 output rows, one 64-pixel m tile each,
//   with its s32 sums in registers (128 a thread). The A operand of output
//   row r, tap (dy, dx), k step s is the slab's row r + dy from column dx,
//   granules 2s and 2s + 1: a shifted window is only another start address of
//   the descriptor (no restaging). After an item's products each warp arrives
//   on the slot's empty barrier, and the producer refills it.
// - Epilogue: each warpgroup requantises its rows into its own staging rows
//   in shared memory (the B->A pad half-pairs zeroed there), each thread
//   storing whole words of neighbouring channels (the n index is a
//   permutation of the channels, ops/nhwc_conv.py:dma_channel_order), then
//   sends them out by one TMA store (a 4-D map (Co, W, H, N), which clips the
//   ragged edge) where Co % 16 == 0, CoT <= Co and out is 16-byte aligned,
//   else by bytes. The producer keeps the next items' boxes in flight
//   meanwhile. The grid is persistent: one block an SM, blockIdx.y the
//   output-channel block, blockIdx.x walking the tiles.
// Each launch gets its plan (CoT, chunk, ring slots, residency, copy modes,
// shared memory, blocks) from ops/nhwc_conv.py:dma_plan and checks it here.
#pragma once

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>

#include "int8_conv_common.cuh"

namespace twv_tma {

constexpr int kTW = 64;              // output columns of a tile: one wgmma m tile
constexpr int kConsumerWarps = 8;    // two warpgroups
constexpr int kThreads = 3 * 128;    // and the producer's warpgroup (one warp works)
// Registers a thread after setmaxnreg: the producer's warpgroup gives up what
// the consumers' s32 tiles need (128 x 56 + 256 x 224 <= 65,536)
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr int kSmemLimit = 232448;   // dynamic shared memory a block may use
constexpr int kAlign = 128;          // TMA boxes, slots and the staging tile
constexpr int kBulkPiece = 65536;    // bytes of one bulk weight copy
// Error codes beyond cudaError_t: cuTensorMapEncodeTiled not found, or
// 1000 + the CUresult with which it refused a tensor map.
constexpr int kErrNoEncoder = 900;
constexpr int kErrEncode = 1000;

// Output rows of a tile: each warpgroup holds rows_per_wg(cot) m tiles of
// 64 x cot s32 sums, 128 registers a thread.
__host__ __device__ constexpr int rows_per_wg(int cot) { return 256 / cot; }
__host__ __device__ constexpr int tile_rows(int cot) { return 2 * rows_per_wg(cot); }

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

struct Args {
  const int8_t* x;  // N images of (Hin, Win, C) int8, Himg * Win * C bytes apart
  const int8_t* w;  // [n_co][n_chunks][taps][kb / 16][CoT][16] int8
  const float* a;
  const float* bias;
  int8_t* out;      // (N, H, W, Co) int8 contiguous
  int N, Hin, Himg, Win, C, H, W, Co;
  int row_off, col_off;
  int chunk, n_chunks, kb, stages;
  int n_th, n_tw, tiles;
  int plane_bytes, slab_bytes, wchunk_bytes, slot_bytes, wres_bytes;
  bool resident, tma_in, tma_out, zero_pad, vec4_in;
  float inv;
  int relu;
};

// -- PTX ------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of `bar` with the given parity has completed. A wait
// of more than 2^34 cycles (seconds; an item takes microseconds) can only be
// a ring that will never complete: the kernel traps, and the launch fails
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// The 5-D box at (c0..c4) of `map` into shared memory at dst; completes `bar`.
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
      "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst; completes `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The 4-D box at (c0..c3) of `map` from shared memory at src, as one bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The shared memory of every committed store has been read.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// This thread's generic-proxy writes to shared memory become visible to the
// async proxy (TMA, wgmma).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerWarps * 32) : "memory");
}

// A wgmma shared-memory operand without swizzle: 8-row core matrices of 16
// bytes a row (128 contiguous bytes); `lbo` bytes from one core matrix to the
// next along k, `sbo` along m (or n).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of this warpgroup's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d = A (64 x 32 s8, descriptor a) x B (32 x N s8, descriptor b), plus d
// itself when scale_d != 0; d is this thread's share of the 64 x N s32 tile:
// d[4j + 2h + e] is row 16 * warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e.
__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}


template <int N>
__device__ __forceinline__ void wgmma(int (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 32) {
    wgmma_n32(d, a, b, scale_d);
  } else if constexpr (N == 64) {
    wgmma_n64(d, a, b, scale_d);
  } else {
    wgmma_n128(d, a, b, scale_d);
  }
}

// -- the kernel -------------------------------------------------------------------

// Tile t's image and top-left output pixel (row h0, column w0).
__device__ __forceinline__ void tile_origin(const Args& p, int t, int th, int& n, int& h0,
                                            int& w0) {
  n = t / (p.n_th * p.n_tw);
  const int r = t - n * (p.n_th * p.n_tw);
  h0 = r / p.n_tw * th;
  w0 = r % p.n_tw * kTW;
}

// 16 channels c..c+15 of the pixel at px, zero past C: four words where the
// input allows it, else bytes.
__device__ __forceinline__ int4 load16(const Args& p, const int8_t* px, int c) {
  if (p.vec4_in) {
    const int* w = reinterpret_cast<const int*>(px + c);
    return make_int4(c < p.C ? w[0] : 0, c + 4 < p.C ? w[1] : 0, c + 8 < p.C ? w[2] : 0,
                     c + 12 < p.C ? w[3] : 0);
  }
  return make_int4(twv::load_word(px, c, p.C), twv::load_word(px, c + 4, p.C),
                   twv::load_word(px, c + 8, p.C), twv::load_word(px, c + 12, p.C));
}

// The producer warp's own copy of an item's slab into a slot, in the TMA box's
// layout [granule][row][column][16 bytes]: zeros outside x and past C.
template <int KW, int TH>
__device__ void fill_slab(const Args& p, uint8_t* slot, int n, int h0, int w0, int chunk,
                          int lane) {
  constexpr int PW = kTW + KW - 1;
  constexpr int kPlane = (TH + 2) * PW;
  const int granules = p.chunk / 16;
  const int8_t* img = p.x + static_cast<long long>(n) * p.Himg * p.Win * p.C;
  for (int i = lane; i < granules * kPlane; i += 32) {
    const int g = i / kPlane;
    const int px = i - g * kPlane;
    const int h = h0 + p.row_off + px / PW;
    const int wc = w0 + p.col_off + px % PW;
    const int c = chunk * p.chunk + 16 * g;
    int4 v = make_int4(0, 0, 0, 0);
    if (h >= 0 && h < p.Hin && wc >= 0 && wc < p.Win && c < p.C) {
      v = load16(p, img + (static_cast<long long>(h) * p.Win + wc) * p.C, c);
    }
    *reinterpret_cast<int4*>(slot + 16 * i) = v;
  }
}

template <int KW, int CoT>
__device__ void producer(const Args& p, const CUtensorMap* in_map, uint8_t* ring,
                         uint8_t* wres, uint32_t bars, int lane) {
  constexpr int TH = tile_rows(CoT);
  const int S = p.stages;
  const int cob = blockIdx.y;
  const int8_t* wblock = p.w + static_cast<long long>(cob) * p.n_chunks * p.wchunk_bytes;
  const uint32_t wbar = bars + 16 * S;
  if (p.resident && lane == 0) {
    const int total = p.n_chunks * p.wchunk_bytes;
    mbar_expect_tx(wbar, total);
    for (int o = 0; o < total; o += kBulkPiece) {
      bulk_load(smem_u32(wres) + o, wblock + o, min(kBulkPiece, total - o), wbar);
    }
  }
  if (p.tma_in && lane != 0) return;
  for (int u = 0;; ++u) {
    const int tile = blockIdx.x + u / p.n_chunks * gridDim.x;
    if (tile >= p.tiles) break;
    const int chunk = u % p.n_chunks;
    const int s = u % S;
    const uint32_t full = bars + 8 * s;
    if (u >= S) mbar_wait(bars + 8 * (S + s), (u / S - 1) & 1);  // the slot is empty
    uint8_t* slot = ring + s * p.slot_bytes;
    int n, h0, w0;
    tile_origin(p, tile, TH, n, h0, w0);
    const int8_t* wsrc = wblock + static_cast<long long>(chunk) * p.wchunk_bytes;
    if (p.tma_in) {
      mbar_expect_tx(full, p.slab_bytes + (p.resident ? 0 : p.wchunk_bytes));
      tma_load_5d(smem_u32(slot), in_map, full, 0, w0 + p.col_off, h0 + p.row_off,
                  chunk * p.chunk / 16, n);
      if (!p.resident) bulk_load(smem_u32(slot) + p.slab_bytes, wsrc, p.wchunk_bytes, full);
      continue;
    }
    fill_slab<KW, TH>(p, slot, n, h0, w0, chunk, lane);
    fence_async_shared();
    __syncwarp();
    if (lane == 0) {
      if (p.resident) {
        mbar_arrive(full);
      } else {
        mbar_expect_tx(full, p.wchunk_bytes);
        bulk_load(smem_u32(slot) + p.slab_bytes, wsrc, p.wchunk_bytes, full);
      }
    }
  }
}

// One output: y = fma(acc, a, b) rounded once (__fmaf_rn, as XLA fuses JAX's
// acc * a + b), then y * inv clipped to [lo, 127] (lo = 0 after a ReLU, whose
// floor this max also applies since inv > 0; -127 without one) and rounded
// half to even by adding 1.5 * 2^23 (exact for |v| <= 127): the low byte of
// the sum's bits is the int8 result. One conversion (s32 -> float) an output
// instead of two.
__device__ __forceinline__ uint32_t requant_bits(int acc, float a, float b, float lo,
                                                 float inv) {
  const float y = __fmaf_rn(__int2float_rn(acc), a, b);
  const float v = fminf(fmaxf(__fmul_rn(y, inv), lo), 127.0f);
  return __float_as_uint(__fadd_rn(v, 12582912.0f));
}

// The low bytes of four requant_bits results as one word (b0 in bits 0-7).
__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

// Word w of a B->A output pixel at column wc holding output channels
// co..co+3, with the bytes of the baked-in W pad zeroed: the lower half of Co
// at column 0, the upper half at column W - 1.
__device__ __forceinline__ uint32_t zero_pad_bytes(const Args& p, uint32_t w, int wc, int co) {
  const int half = p.Co / 2;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if ((wc == 0 && co + e < half) || (wc == p.W - 1 && co + e >= half)) {
      w &= ~(0xFFu << (8 * e));
    }
  }
  return w;
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// The requantised int8 outputs of row r of this warpgroup's part of a tile
// (sums d) into its staging rows [r][64 pixels][CoT]. The wgmma's n index is
// a permutation of the block's output channels (ops/nhwc_conv.py:
// dma_channel_order): thread q of a quad holds cot / 4 neighbouring channels
// of each of its pixels and stores them as whole 16-byte (8 at cot 32) words,
// without bank conflicts. A B->A output's pad bytes are zeroed on the tiles
// at the two edges.
template <int CoT>
__device__ __forceinline__ void epilogue_row(const Args& p, const int (&d)[CoT / 2],
                                             uint8_t* srow, const float* aq, const float* bq,
                                             float lo, int w0, int co0, int wl, int g, int q) {
  constexpr int kQ = CoT / 4;       // channels of one thread of a quad
  constexpr int kWords = CoT / 16;  // its words, a pixel
  uint32_t words[2][kWords];
#pragma unroll
  for (int w4 = 0; w4 < kWords; ++w4) {
    const float4 av = *reinterpret_cast<const float4*>(aq + 4 * w4);
    const float4 bv = *reinterpret_cast<const float4*>(bq + 4 * w4);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i0 = 8 * w4 + 2 * hf;  // n tile 2 w4 (channels +0, +1), then 2 w4 + 1
      words[hf][w4] = pack4(requant_bits(d[i0], av.x, bv.x, lo, p.inv),
                            requant_bits(d[i0 + 1], av.y, bv.y, lo, p.inv),
                            requant_bits(d[i0 + 4], av.z, bv.z, lo, p.inv),
                            requant_bits(d[i0 + 5], av.w, bv.w, lo, p.inv));
    }
  }
  if (p.zero_pad && (w0 == 0 || w0 + kTW >= p.W)) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int w4 = 0; w4 < kWords; ++w4) {
        words[hf][w4] = zero_pad_bytes(p, words[hf][w4], w0 + 16 * wl + g + 8 * hf,
                                       co0 + q * kQ + 4 * w4);
      }
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    uint8_t* px = srow + (16 * wl + g + 8 * hf) * CoT + q * kQ;
    const uint32_t* w = words[hf];
    if constexpr (CoT == 32) {
      *reinterpret_cast<uint2*>(px) = make_uint2(w[0], w[1]);
    } else if constexpr (CoT == 64) {
      *reinterpret_cast<uint4*>(px) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      // rows g and g + 1 share the banks of their halves: odd rows store their
      // second half first
      const bool odd = g & 1;
      const uint4 h0w = make_uint4(w[0], w[1], w[2], w[3]);
      const uint4 h1w = make_uint4(w[4], w[5], w[6], w[7]);
      *reinterpret_cast<uint4*>(px + (odd ? 16 : 0)) = odd ? h1w : h0w;
      *reinterpret_cast<uint4*>(px + (odd ? 0 : 16)) = odd ? h0w : h1w;
    }
  }
}

// This warpgroup's staged rows of a tile (image n, first row h0, column w0)
// to device memory: one TMA store by its first thread, or bytes.
template <int CoT>
__device__ __forceinline__ void store_rows(const Args& p, const CUtensorMap* out_map,
                                           const uint8_t* stage, int n, int h0, int w0, int co0,
                                           int wtid) {
  constexpr int R = rows_per_wg(CoT);
  if (h0 >= p.H) return;
  if (p.tma_out) {
    if (wtid == 0) tma_store_4d(out_map, smem_u32(stage), co0, w0, h0, n);
    return;
  }
  for (int i = wtid; i < R * kTW * CoT; i += 128) {
    const int co = co0 + i % CoT;
    const int px = i / CoT;
    const int h = h0 + px / kTW;
    const int wc = w0 + px % kTW;
    if (co < p.Co && h < p.H && wc < p.W) {
      p.out[((static_cast<long long>(n) * p.H + h) * p.W + wc) * p.Co + co] =
          static_cast<int8_t>(stage[i]);
    }
  }
}

// The consumers. Warpgroup wg owns output rows wg * R .. wg * R + R - 1 of
// every tile and synchronises only with itself around its epilogue. At
// N = 128 the two take the tensor cores in turns (kTurns): warpgroup 0's
// products of item u, then warpgroup 1's, then warpgroup 0's of item u + 1,
// so that one's epilogue runs while the other's products keep the tensor
// cores busy. An item's products go out as two groups, all taps but the last
// and the last; the turn passes when the first group has completed, so the
// other warpgroup's products follow without a gap and without running
// alongside (turn barriers at bars + 8 (2S + 1 + w)). At N <= 64 one
// warpgroup's products alone leave the tensor cores idle about half the
// time (their 2 to 4 accumulator chains of 32-clock products do not cover
// the pipeline's latency), so both send their products at once and drift
// apart as their epilogues allow. The first product of a tile overwrites its
// sums (scale_d = 0).
template <int KW, int CoT>
__device__ void consumer(const Args& p, const CUtensorMap* out_map, uint8_t* ring,
                         uint8_t* wres, uint8_t* stage, const float* ab, uint32_t bars) {
  constexpr int R = rows_per_wg(CoT);
  constexpr int PW = kTW + KW - 1;
  constexpr int kTaps = 3 * KW;
  const int S = p.stages;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int wtid = tid % 128;
  const int wl = wtid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int co0 = blockIdx.y * CoT;
  const uint32_t ring_a = smem_u32(ring);
  const uint32_t wres_a = smem_u32(wres);
  uint8_t* my_stage = stage + wg * R * kTW * CoT;
  const int ksteps = p.chunk >= 32 ? p.chunk / 32 : 1;
  // a 16-channel chunk fills half a k step: its second half reads the first
  // granule again, against zero weights
  const uint32_t a_lbo = p.chunk >= 32 ? p.plane_bytes : 0;
  const uint32_t b_lbo = CoT * 16;
  const int kg = p.kb / 16;
  const float lo = p.relu ? 0.0f : -127.0f;
  const float* aq = ab + q * (CoT / 4);
  const float* bq = ab + CoT + q * (CoT / 4);
  constexpr bool kTurns = CoT == 128;
  const uint32_t turn_mine = bars + 8 * (2 * S + 1 + wg);
  const uint32_t turn_other = bars + 8 * (2 * S + 2 - wg);

  if (p.resident) mbar_wait(bars + 16 * S, 0);
  int acc[R][CoT / 2];
  for (int u = 0;; ++u) {
    const int tile = blockIdx.x + u / p.n_chunks * gridDim.x;
    if (tile >= p.tiles) break;
    const int chunk = u % p.n_chunks;
    const int s = u % S;
    mbar_wait(bars + 8 * s, (u / S) & 1);  // the item's slab (and weights) have landed
    if (kTurns) mbar_wait(turn_mine, (u + 1 + wg) & 1);  // the other's turn is over
    const uint32_t slab = ring_a + s * p.slot_bytes;
    const uint32_t wt = p.resident ? wres_a + chunk * p.wchunk_bytes : slab + p.slab_bytes;
    auto tap = [&](int t) {
      const int dy = t / KW;
      const int dx = t % KW;
      for (int k = 0; k < ksteps; ++k) {
        const uint64_t db = desc(wt + (t * kg + 2 * k) * CoT * 16, b_lbo, 128);
        const uint32_t a0 = slab + 2 * k * p.plane_bytes + ((wg * R + dy) * PW + dx) * 16;
        const int scale_d = chunk > 0 || t > 0 || k > 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          wgmma<CoT>(acc[r], desc(a0 + r * PW * 16, a_lbo, 128), db, scale_d);
        }
      }
    };
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kTaps - 1; ++t) tap(t);
    wgmma_commit();
    tap(kTaps - 1);
    wgmma_commit();
    if (kTurns) {
      wgmma_wait<1>();
      __syncwarp();
      if (lane == 0) mbar_arrive(turn_other);
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (S + s));  // this warp is done with the slot
    if (chunk != p.n_chunks - 1) continue;

    // the epilogue of this warpgroup's rows; its staging rows are free once
    // its last store has read them
    int n, h0, w0;
    tile_origin(p, tile, tile_rows(CoT), n, h0, w0);
    if (wtid == 0 && p.tma_out) bulk_wait_read();
    wg_sync(wg);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      epilogue_row<CoT>(p, acc[r], my_stage + r * kTW * CoT, aq, bq, lo, w0, co0, wl, g, q);
    }
    if (p.tma_out) fence_async_shared();
    wg_sync(wg);
    store_rows<CoT>(p, out_map, my_stage, n, h0 + wg * R, w0, co0, wtid);
  }
  if (wtid == 0 && p.tma_out) bulk_wait_all();
}

template <int KW, int CoT>
__global__ void __launch_bounds__(kThreads, 1)
    tma_conv_kernel(const __grid_constant__ CUtensorMap in_map,
                    const __grid_constant__ CUtensorMap out_map, const Args p) {
  constexpr int TH = tile_rows(CoT);
  extern __shared__ __align__(kAlign) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (kAlign - smem_u32(smem_raw) % kAlign) % kAlign;
  uint8_t* ring = smem;
  uint8_t* wres = ring + p.stages * p.slot_bytes;
  uint8_t* stage = wres + p.wres_bytes;
  float* ab = reinterpret_cast<float*>(stage + TH * kTW * CoT);
  // full barrier of slot s at bars + 8s, its empty barrier at bars + 8(S + s),
  // the resident weights' at bars + 16S
  const uint32_t bars = smem_u32(ab + 2 * CoT);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (p.stages + s), kConsumerWarps);
    }
    mbar_init(bars + 16 * p.stages, 1);
    mbar_init(bars + 8 * (2 * p.stages + 1), 4);
    mbar_init(bars + 8 * (2 * p.stages + 2), 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < CoT) {
    const int co = blockIdx.y * CoT + threadIdx.x;
    ab[threadIdx.x] = co < p.Co ? p.a[co] : 0.0f;
    ab[CoT + threadIdx.x] = co < p.Co ? p.bias[co] : 0.0f;
  }
  __syncthreads();
  if (threadIdx.x >= kConsumerWarps * 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < kConsumerWarps * 32 + 32) {
      producer<KW, CoT>(p, &in_map, ring, wres, bars, threadIdx.x % 32);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consumer<KW, CoT>(p, &out_map, ring, wres, stage, ab, bars);
  }
}

// -- the host side --------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the CUDA runtime's entry-point query
// (no -lcuda).
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                                  cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A uint8 tensor map without swizzle whose out-of-bounds elements read zero.
inline int encode(CUtensorMap* map, int rank, const void* base, const cuuint64_t* dims,
                  const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), dims,
                        strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

// Bytes of dynamic shared memory of a plan (ops/nhwc_conv.py:_dma_smem).
inline int plan_smem(const Args& p, int cot) {
  return kAlign + p.stages * p.slot_bytes + p.wres_bytes + tile_rows(cot) * kTW * cot +
         8 * cot + 8 * (2 * p.stages + 3);
}

template <int KW, int CoT>
int launch_cot(const Args& p, const CUtensorMap& in_map, const CUtensorMap& out_map, int smem,
               int blocks, int n_co, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      tma_conv_kernel<KW, CoT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  tma_conv_kernel<KW, CoT><<<dim3(blocks, n_co), kThreads, smem, stream>>>(in_map, out_map, p);
  return static_cast<int>(cudaGetLastError());
}

// Checks the plan (computed by ops/nhwc_conv.py:dma_plan) against the shape,
// fills its part of p (the caller sets the pointers, N, Hin, Himg, Win, C, H,
// W, Co, row_off, col_off, zero_pad, inv and relu), builds the tensor maps and
// launches. → 0, a cudaError_t, kErrNoEncoder or kErrEncode + CUresult.
template <int KW>
int launch(Args p, int cot, int chunk, int stages, int resident, int tma_in, int tma_out,
           int smem, int blocks, cudaStream_t stream) {
  constexpr int PW = kTW + KW - 1;
  const int th = tile_rows(cot);
  const bool ok = p.N >= 1 && p.Hin >= 1 && p.Himg >= p.Hin && p.Win >= 1 && p.C >= 1 &&
                  p.H >= 1 && p.W >= 1 &&
                  p.Co >= 1 && (cot == 32 || cot == 64 || cot == 128) &&
                  (chunk == 16 || chunk == 32 || chunk == 64 || chunk == 128) &&
                  chunk <= round_up(p.C, 16) && stages >= 2 && stages <= 4 &&
                  twv::aligned(p.w, 16);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int n_co = (p.Co + cot - 1) / cot;
  const long long tiles = static_cast<long long>(p.N) * ((p.H + th - 1) / th) *
                          ((p.W + kTW - 1) / kTW);
  p.chunk = chunk;
  p.n_chunks = (p.C + chunk - 1) / chunk;
  p.kb = chunk < 32 ? 32 : chunk;
  p.stages = stages;
  p.n_th = (p.H + th - 1) / th;
  p.n_tw = (p.W + kTW - 1) / kTW;
  p.plane_bytes = (th + 2) * PW * 16;
  p.slab_bytes = chunk / 16 * p.plane_bytes;
  p.wchunk_bytes = 3 * KW * p.kb * cot;
  p.resident = resident != 0;
  p.slot_bytes = round_up(p.slab_bytes + (p.resident ? 0 : p.wchunk_bytes), kAlign);
  p.wres_bytes = p.resident ? round_up(p.n_chunks * p.wchunk_bytes, kAlign) : 0;
  // a tensor map needs 16-byte strides and base: the channels and the
  // output channels a multiple of 16, the pointers aligned
  const bool in_legal = p.C % 16 == 0 && twv::aligned(p.x, 16);
  const bool out_legal = p.Co % 16 == 0 && cot <= p.Co && twv::aligned(p.out, 16);
  if (n_co > 65535 || tiles > INT_MAX / 2 || plan_smem(p, cot) != smem || smem > kSmemLimit ||
      blocks < 1 || blocks > tiles || (tma_in != 0) != in_legal ||
      (tma_out != 0) != out_legal) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.tiles = static_cast<int>(tiles);
  p.tma_in = in_legal;
  p.tma_out = out_legal;
  p.vec4_in = p.C % 4 == 0 && twv::aligned(p.x, 4);
  CUtensorMap in_map{}, out_map{};
  if (p.tma_in) {
    const cuuint64_t dims[5] = {16, static_cast<cuuint64_t>(p.Win),
                                static_cast<cuuint64_t>(p.Hin),
                                static_cast<cuuint64_t>(p.C / 16),
                                static_cast<cuuint64_t>(p.N)};
    const cuuint64_t px = static_cast<cuuint64_t>(p.C);
    const cuuint64_t strides[4] = {px, px * p.Win, 16, px * p.Win * p.Himg};
    const cuuint32_t box[5] = {16, static_cast<cuuint32_t>(PW), static_cast<cuuint32_t>(th + 2),
                               static_cast<cuuint32_t>(chunk / 16), 1};
    const int e = encode(&in_map, 5, p.x, dims, strides, box);
    if (e != 0) return e;
  }
  if (p.tma_out) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(p.Co), static_cast<cuuint64_t>(p.W),
                                static_cast<cuuint64_t>(p.H), static_cast<cuuint64_t>(p.N)};
    const cuuint64_t px = static_cast<cuuint64_t>(p.Co);
    const cuuint64_t strides[3] = {px, px * p.W, px * p.W * p.H};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(cot), kTW,
                               static_cast<cuuint32_t>(rows_per_wg(cot)), 1};
    const int e = encode(&out_map, 4, p.out, dims, strides, box);
    if (e != 0) return e;
  }
  switch (cot) {
    case 32: return launch_cot<KW, 32>(p, in_map, out_map, smem, blocks, n_co, stream);
    case 64: return launch_cot<KW, 64>(p, in_map, out_map, smem, blocks, n_co, stream);
    default: return launch_cot<KW, 128>(p, in_map, out_map, smem, blocks, n_co, stream);
  }
}

}  // namespace twv_tma
