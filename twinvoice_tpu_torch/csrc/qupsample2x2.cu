// K6 on Hopper: int8 2x2 stride-2 transpose convolution on the int8 tensor
// cores with an s32 sum, then dequantise -> bias -> symmetric requantise (no
// ReLU), int8 in and int8 out.
//
// Replaces twinvoice_tpu/ops/qconv_pallas.py:qupsample2x2_requant. Same
// contract: the taps do not overlap, so each output pixel is one Cin-long dot
//   y[n, 2h+dy, 2w+dx, co] = sum_ci K[co, dy, dx, ci] * x[n, h, w, ci]
// (the orientation of pack_wup: quant._conv_transpose2x2_i8's explicit flip
// cancels conv_transpose's own rotation), then, with the multiply and the
// bias add fused into one rounding (__fmaf_rn) as XLA fuses them under jit and
// every other step one correctly rounded float32 operation,
//   q = clip(rint(fma(acc, s0 * w_scale[co], bias[co]) * inv), -127, 127).
// Activations are NHWC-contiguous int8, the weight is (Co, 2, 2, Cin) int8;
// any N, H, W, Cin >= 1 and Co >= 1, aligned or not.
//
// Bound: at w16, b128 the level-0 upsample reads 268 MB (128 x 256^2 x 32) and
// writes 537 MB (128 x 512^2 x 16): 0.24 ms at 3.35 TB/s against 69 GOP
// (0.035 ms at 1,979 TOP/s int8 on the tensor cores), so it is bound by
// bytes, and the writes are two thirds of them. Every w16 shape does the same
// 17.2 G MAC and is bound by bytes.
//
// Design: a GEMM, not a conv (no halo, no tap shift), on mma.sync m16n8k32 s8
// fed by ldmatrix (int8_mma_conv.cuh). M = the input pixels, NHWC rows of Cin
// bytes (row-major A as ldmatrix hands it); K = Cin in 32-byte k steps, zeros
// past Cin; N = 4 Co columns, one for each (tap, channel): a block owns CoT =
// 8, 16 or 32 output channels, 4 CoT columns ordered tap-major, whose
// weights are rows (co, tap) of the (Co, 2, 2, Cin) tensor as it lies (each
// already k-contiguous, the column-major B the mma takes). A tile is TM = 256
// consecutive input pixels (128 at CoT = 32); the 8 warps split it into
// 32-pixel strips (and, at CoT = 32, the columns into two halves), each warp
// two m tiles by 4 or 8 n tiles. Cin is walked in chunks of kc = 32, 64 or
// 128 channels through a cp.async ring of 2 to 4 slots in shared memory; the
// block's weights stay resident when its chunks fit in the ring, else ride in
// it beside the pixels. The grid is persistent (the plan sizes it to the
// blocks that fit on the card). The int8 results are staged in shared memory
// as [pixel][tap][channel]; then, for each input pixel and each dy, its dx = 0
// and dx = 1 outputs are one run of 2 CoT bytes of output row 2h + dy, written
// as 16-byte stores by neighbouring threads on neighbouring addresses (with
// Co = CoT the runs of a row's pixels are one contiguous stretch), or byte by
// byte when Co % 16 != 0 or the pointer forbids it. Each column's s0 *
// w_scale and bias sit in shared memory for the block's life.
//
// What holds it back (PERF.md): at 32 MACs an output byte the tensor cores
// idle; the requant (five instructions an output) and the staged stores are
// issued by the same warps that wait on the ring, one tile after another
// between two barriers. With the float epilogue compiled out the level-0
// shape took 0.41 ms instead of 0.53, with the stores compiled out 0.36; a
// ring of 7 slots instead of 4, or three blocks an SM, changed nothing.
//
// C interface for ctypes: twv_qupsample2x2_requant checks the plan it is given
// (ops/qupsample.py:qupsample_plan: channels a block, chunk, ring slots,
// shared-memory bytes, blocks), launches on the given stream and returns
// cudaGetLastError() as an int (0 = launched).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "int8_conv_common.cuh"
#include "int8_mma_conv.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMT = 2;  // m tiles of 16 pixels a warp
constexpr int kSmemLimit = 232448;

// The block shape for CoT output channels: TN = 4 CoT GEMM columns, split
// over WN warps of NT n tiles each; WM warps down TM pixels.
template <int CoT>
struct Shape {
  static constexpr int TN = 4 * CoT;
  static constexpr int WN = CoT == 32 ? 2 : 1;
  static constexpr int WM = kWarps / WN;
  static constexpr int NT = TN / 8 / WN;
  static constexpr int TM = WM * kMT * 16;
};

__host__ __device__ constexpr int tile_pixels(int cot) { return cot == 32 ? 128 : 256; }

struct Args {
  const int8_t* x;  // (N, H, W, Cin) int8 contiguous
  const int8_t* w;  // (Co, 2, 2, Cin) int8 contiguous
  const float* w_scale;
  const float* bias;
  int pixels, W, Cin, Co;              // N H W input pixels, their width
  int kc, lg16, k_chunks, stages, tiles;  // chunk channels (16 << lg16); chunks; ring slots; tiles
  int sa, wb, ob;                         // pixel, weight row, output pixel bytes in smem
  int a_bytes, b_bytes, o_bytes;          // one slot's pixels; one chunk's weights; outputs
  bool vec_x, vec_w, vec_out, resident;
  float s0, inv;
  int8_t* out;  // (N, 2H, 2W, Co) int8 contiguous
};

// 16 bytes of channels c..c+15 at px (zero past C), by bytes.
__device__ __forceinline__ int4 load16(const int8_t* px, int c, int C) {
  return make_int4(twv::load_word(px, c, C), twv::load_word(px, c + 4, C),
                   twv::load_word(px, c + 8, C), twv::load_word(px, c + 12, C));
}

// Chunk `chunk` of the tile's TM pixels, [pixel][kc bytes]; zeros past the
// batch and past Cin.
template <int CoT>
__device__ void stage_pixels(const Args& p, uint8_t* dst, int tile, int chunk) {
  constexpr int TM = Shape<CoT>::TM;
  const int lg = p.lg16;
  const int c0 = chunk * p.kc;
  for (int i = threadIdx.x; i < TM << lg; i += kThreads) {
    const int px = i >> lg;
    const int c = c0 + 16 * (i & ((1 << lg) - 1));
    const int pix = tile * TM + px;
    const int8_t* src = p.x + static_cast<long long>(pix) * p.Cin;
    uint8_t* d = dst + px * p.sa + (c - c0);
    if (p.vec_x) {
      const bool ok = pix < p.pixels && c < p.Cin;
      twv::cp_async16(d, ok ? src + c : p.x, ok ? 16 : 0);
    } else {
      *reinterpret_cast<int4*>(d) =
          pix < p.pixels ? load16(src, c, p.Cin) : make_int4(0, 0, 0, 0);
    }
  }
}

// Chunk `chunk` of the block's weights, [column][kc bytes]: column n is tap
// n / CoT of channel co0 + n % CoT; zeros past Cin and past Co.
template <int CoT>
__device__ void stage_weights(const Args& p, uint8_t* dst, int co0, int chunk) {
  constexpr int TN = Shape<CoT>::TN;
  const int g16 = p.kc / 16;
  const int c0 = chunk * p.kc;
  for (int i = threadIdx.x; i < TN * g16; i += kThreads) {
    const int n = i / g16;
    const int k = i - n * g16;
    const int co = co0 + n % CoT;
    const int c = c0 + 16 * k;
    const bool ok = co < p.Co && c < p.Cin;
    const int8_t* src = p.w + (static_cast<long long>(co) * 4 + n / CoT) * p.Cin;
    uint8_t* d = dst + n * p.wb + 16 * k;
    if (p.vec_w) {
      twv::cp_async16(d, ok ? src + c : p.w, ok ? 16 : 0);
    } else {
      *reinterpret_cast<int4*>(d) = ok ? load16(src, c, p.Cin) : make_int4(0, 0, 0, 0);
    }
  }
}

// The products of one chunk added to warp `warp`'s sums: m tile mt covers
// pixels wm * 32 + 16 mt .. + 15 of the tile, n tile j columns
// (wn * NT + j) * 8 .. + 7.
template <int CoT>
__device__ __forceinline__ void mma_chunk(int (&acc)[kMT][Shape<CoT>::NT][4], const Args& p,
                                          const uint8_t* a, const uint8_t* b, int warp,
                                          int lane) {
  using S = Shape<CoT>;
  const int wm = warp % S::WM;
  const int wn = warp / S::WM;
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const unsigned abase =
      twv::smem_addr(a) + (wm * kMT * 16 + arow) * p.sa + 16 * (lane >> 4);
  const unsigned bbase = twv::smem_addr(b) + wn * S::NT * 8 * p.wb;
  for (int kb = 0; kb < p.kc; kb += 32) {
    int af[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) twv::ldsm_x4(af[mt], abase + mt * 16 * p.sa + kb);
#pragma unroll
    for (int j = 0; j < S::NT; j += 2) {
      int bf[4];
      twv::load_b<S::NT>(bf, bbase, p.wb, j, kb, lane);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        twv::mma_s8(acc[mt][j], af[mt], bf[0], bf[1]);
        twv::mma_s8(acc[mt][j + 1], af[mt], bf[2], bf[3]);
      }
    }
  }
}

template <int CoT>
__device__ __forceinline__ void zero(int (&acc)[kMT][Shape<CoT>::NT][4]) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int j = 0; j < Shape<CoT>::NT; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][j][r] = 0;
    }
  }
}

// The requantised outputs of warp `warp` into the staging area
// [pixel][column], two neighbouring columns (one tap, two channels) a 16-bit
// store; asc and bsc hold each column's s0 * w_scale and bias. The clip is
// split around the round, both bounds being integers: max(v, -127) before
// it, then __float2int_rn (half to even, as rintf) and cvt.pack.sat's
// saturation at 127, five instructions an output.
template <int CoT>
__device__ __forceinline__ void epilogue(const Args& p, const int (&acc)[kMT][Shape<CoT>::NT][4],
                                         const float* asc, const float* bsc, uint8_t* osm,
                                         int warp, int lane) {
  using S = Shape<CoT>;
  const int wm = warp % S::WM;
  const int wn = warp / S::WM;
  const int g = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < S::NT; ++j) {
    const int n = (wn * S::NT + j) * 8 + 2 * q;  // columns n, n + 1: one tap
    const float2 av = *reinterpret_cast<const float2*>(asc + n);
    const float2 bv = *reinterpret_cast<const float2*>(bsc + n);
    const float a[2] = {av.x, av.y};
    const float b[2] = {bv.x, bv.y};
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        int v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y = __fmaf_rn(__int2float_rn(acc[mt][j][2 * hf + e]), a[e], b[e]);
          v[e] = __float2int_rn(fmaxf(__fmul_rn(y, p.inv), -127.0f));
        }
        const int px = wm * kMT * 16 + mt * 16 + g + 8 * hf;
        *reinterpret_cast<uint16_t*>(osm + px * p.ob + n) =
            static_cast<uint16_t>(twv::pack2_s8(v[0], v[1]));
      }
    }
  }
}

// The tile's staged outputs to device memory. Input pixel pix = row * W + w
// (row = n * H + h) puts tap (dy, dx) at output row 2 row + dy, column
// 2 w + dx. 16-byte stores ordered (dy, pixel, dx, granule), so that threads
// side by side write side by side; else bytes.
template <int CoT>
__device__ __forceinline__ void store_tile(const Args& p, const uint8_t* osm, int tile,
                                           int co0) {
  constexpr int TM = Shape<CoT>::TM;
  const long long W2 = 2LL * p.W;
  if (p.vec_out) {
    constexpr int G = CoT / 16;
    for (int i = threadIdx.x; i < TM * 4 * G; i += kThreads) {
      const int gi = i % G;
      int r = i / G;
      const int dx = r & 1;
      r >>= 1;
      const int px = r % TM;
      const int dy = r / TM;
      const int pix = tile * TM + px;
      const int co = co0 + 16 * gi;
      if (pix >= p.pixels || co >= p.Co) continue;
      const int row = pix / p.W;
      const int wc = pix - row * p.W;
      *reinterpret_cast<int4*>(p.out + ((2LL * row + dy) * W2 + 2 * wc + dx) * p.Co + co) =
          *reinterpret_cast<const int4*>(osm + px * p.ob + (2 * dy + dx) * CoT + 16 * gi);
    }
  } else {
    for (int i = threadIdx.x; i < TM * 4 * CoT; i += kThreads) {
      const int c = i % CoT;
      const int r = i / CoT;
      const int tap = r & 3;
      const int px = r >> 2;
      const int pix = tile * TM + px;
      if (pix >= p.pixels || co0 + c >= p.Co) continue;
      const int row = pix / p.W;
      const int wc = pix - row * p.W;
      p.out[((2LL * row + tap / 2) * W2 + 2 * wc + tap % 2) * p.Co + co0 + c] =
          static_cast<int8_t>(osm[px * p.ob + tap * CoT + c]);
    }
  }
}

template <int CoT>
__global__ void __launch_bounds__(kThreads, 2) qupsample2x2_kernel(Args p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int S = p.stages;
  uint8_t* ring = smem;
  uint8_t* wsm = smem + S * p.a_bytes;
  uint8_t* osm = wsm + min(p.k_chunks, S) * p.b_bytes;
  float* asc = reinterpret_cast<float*>(osm + p.o_bytes);  // [column] s0 * w_scale
  float* bsc = asc + Shape<CoT>::TN;                         // [column] bias
  const int co0 = blockIdx.y * CoT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int n = threadIdx.x; n < Shape<CoT>::TN; n += kThreads) {
    const int co = co0 + n % CoT;
    asc[n] = co < p.Co ? __fmul_rn(p.s0, p.w_scale[co]) : 0.0f;
    bsc[n] = co < p.Co ? p.bias[co] : 0.0f;
  }
  // item i: chunk i % k_chunks of tile blockIdx.x + (i / k_chunks) gridDim.x
  auto tile_of = [&](int i) {
    return static_cast<int>(blockIdx.x) + i / p.k_chunks * static_cast<int>(gridDim.x);
  };
  auto stage = [&](int j) {
    const int tile = tile_of(j);
    if (tile >= p.tiles) return;
    stage_pixels<CoT>(p, ring + j % S * p.a_bytes, tile, j % p.k_chunks);
    if (!p.resident) stage_weights<CoT>(p, wsm + j % S * p.b_bytes, co0, j % p.k_chunks);
  };
  // resident weights join item 0's group; items 0..S-2 are in flight before
  // the loop, one group each
  if (p.resident) {
    for (int c = 0; c < p.k_chunks; ++c) stage_weights<CoT>(p, wsm + c * p.b_bytes, co0, c);
  }
  for (int j = 0; j < S - 1; ++j) {
    stage(j);
    twv::cp_async_commit();
  }
  int acc[kMT][Shape<CoT>::NT][4];
  zero<CoT>(acc);
  for (int i = 0;; ++i) {
    const int tile = tile_of(i);
    if (tile >= p.tiles) break;
    stage(i + S - 1);
    twv::cp_async_commit();
    twv::wait_oldest(S);  // item i's pixels (and weights) have landed
    __syncthreads();
    const int chunk = i % p.k_chunks;
    mma_chunk<CoT>(acc, p, ring + i % S * p.a_bytes,
                   wsm + (p.resident ? chunk : i % S) * p.b_bytes, warp, lane);
    const bool last = chunk == p.k_chunks - 1;
    if (last) epilogue<CoT>(p, acc, asc, bsc, osm, warp, lane);
    __syncthreads();  // every warp is done with item i's slot, and osm is complete
    if (last) {
      store_tile<CoT>(p, osm, tile, co0);
      zero<CoT>(acc);
    }
  }
  twv::cp_async_wait<0>();
}

template <int CoT>
int launch(const Args& p, int smem, int blocks, int n_co, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      qupsample2x2_kernel<CoT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  qupsample2x2_kernel<CoT><<<dim3(blocks, n_co), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (N, H, W, Cin) int8 NHWC-contiguous; w: (Co, 2, 2, Cin) int8 contiguous;
// w_scale, bias: (Co,) float32; out: (N, 2H, 2W, Co) int8 contiguous; all on
// the device. s0 and out_inv are the epilogue's scalars (see the note above).
// The plan (ops/qupsample.py:qupsample_plan): co_tile output channels a block
// (8, 16 or 32), kc channels a chunk (32, 64 or 128), stages slots of the ring
// (2 to 4), smem bytes of dynamic shared memory, blocks along the tiles;
// gridDim.y is ceil(Co / co_tile).
extern "C" int twv_qupsample2x2_requant(const void* x, const void* w,
                                        const void* w_scale, const void* bias,
                                        int N, int H, int W, int Cin, int Co,
                                        float s0, float out_inv, int co_tile, int kc,
                                        int stages, int smem, int blocks, void* out,
                                        void* stream) {
  if (N < 1 || H < 1 || W < 1 || Cin < 1 || Co < 1 ||
      (co_tile != 8 && co_tile != 16 && co_tile != 32) ||
      (kc != 32 && kc != 64 && kc != 128) || stages < 2 || stages > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long pixels = static_cast<long long>(N) * H * W;
  const int tm = tile_pixels(co_tile);
  const long long tiles = (pixels + tm - 1) / tm;
  const int n_co = (Co + co_tile - 1) / co_tile;
  const int k_chunks = (Cin + kc - 1) / kc;
  Args p;
  p.sa = twv::pixel_bytes(kc);
  p.wb = p.sa;
  p.ob = twv::pixel_bytes(4 * co_tile);
  p.a_bytes = tm * p.sa;
  p.b_bytes = 4 * co_tile * p.wb;
  p.o_bytes = tm * p.ob;
  const long long need = static_cast<long long>(stages) * p.a_bytes +
                         static_cast<long long>(k_chunks < stages ? k_chunks : stages) *
                             p.b_bytes +
                         p.o_bytes + 2 * 4 * 4 * co_tile;
  if (pixels > INT_MAX / 2 || n_co > 65535 || need != smem || smem > kSmemLimit ||
      blocks < 1 || blocks > tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.w_scale = static_cast<const float*>(w_scale);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<int8_t*>(out);
  p.pixels = static_cast<int>(pixels);
  p.W = W;
  p.Cin = Cin;
  p.Co = Co;
  p.kc = kc;
  p.lg16 = kc == 128 ? 3 : kc == 64 ? 2 : 1;
  p.k_chunks = k_chunks;
  p.stages = stages;
  p.tiles = static_cast<int>(tiles);
  p.vec_x = Cin % 16 == 0 && twv::aligned(x, 16);
  p.vec_w = Cin % 16 == 0 && twv::aligned(w, 16);
  p.vec_out = Co % 16 == 0 && co_tile >= 16 && twv::aligned(out, 16);
  p.resident = k_chunks <= stages;
  p.s0 = s0;
  p.inv = out_inv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (co_tile) {
    case 8: return launch<8>(p, smem, blocks, n_co, st);
    case 16: return launch<16>(p, smem, blocks, n_co, st);
    default: return launch<32>(p, smem, blocks, n_co, st);
  }
}
