// K7b on Hopper: the pair-packed int8 3x3 SAME convolution with an s32 sum,
// then the dequantise -> bias -> (ReLU) -> requantise epilogue, int8 in and
// int8 out, mapping a phase-A input to phase B or a phase-B input to phase A.
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
// kernel's acc * a + b under jit, then ReLU when asked and q = rint(y * inv) clipped to
// [0, 127] after a ReLU and to [-127, 127] without one (half to even, as
// jnp.round). A B->A output is phase A: the lower half of pair 0 and the
// upper half of pair P_out - 1 are the baked-in W pad and are written as
// zeros, which the next A->B conv reads.
//
// Bound: at w16, b128, 512^2 the three serving calls move 1.08 GB (A->B,
// Cpk = Co2 = 32) and 1.61 GB (B->A, Cpk = 64), 0.32 and 0.48 ms at
// 3.35 TB/s, against 103 and 207 G MAC (0.10 and 0.21 ms at 1,979 TOP/s int8
// on the tensor cores): bound by bytes. The packing costs 12 MACs of a 3x3
// conv's 9 for each input channel and output channel of a pixel pair's two
// columns (1.33x). This first kernel runs on the CUDA cores (__dp4a), as K4a
// (csrc/qconv3x3.cu) does, and shares its design; the tensor cores and a
// cp.async/TMA ring are later work.
//
// Design: a block computes an 8 x 32 tile of output pairs of one image for 16
// output channels, one pair per thread with 16 s32 sums in registers. Cpk is
// walked in chunks of 4*Q channels: the (8+2) x (32+1) halo tile of input
// pairs and the chunk's 6 taps of weights are staged in shared memory, rows
// and pairs outside x and channels past Cpk as zeros. A pair's words sit at an
// odd stride, so the 32 threads of a warp read 32 different banks; every
// thread reads the same weight word at once (a broadcast).
//
// C interface for ctypes: twv_qconv3x3_pair_requant launches on the given
// stream and returns cudaGetLastError() as an int (0 = launched).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTH = 8;
constexpr int kTP = 32;
constexpr int kThreads = kTH * kTP;
constexpr int kCoT = 16;  // output channels per block
constexpr int kTaps = 6;  // 3 rows x 2 pair views
constexpr int kTileP = kTP + 1;
constexpr int kTilePix = (kTH + 2) * kTileP;

template <int Q>
__host__ __device__ constexpr int pixel_stride() {
  return Q % 2 ? Q : Q + 1;
}

// Channels c..c+3 of the pair at p as one word, zero past C.
__device__ __forceinline__ int load_word(const int8_t* p, int c, int C, bool vec4) {
  if (vec4) return c < C ? *reinterpret_cast<const int*>(p + c) : 0;
  unsigned v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (c + j < C) v |= static_cast<unsigned>(static_cast<uint8_t>(p[c + j])) << (8 * j);
  }
  return static_cast<int>(v);
}

// Tile pair j of tile row r is input pair pin0 + j of row h0 + r - 1.
template <int Q>
__device__ void stage_tile(int* dst, const int8_t* __restrict__ x, int n, int h0,
                           int pin0, int H, int P, int C, int c0, bool vec4) {
  constexpr int PS = pixel_stride<Q>();
  for (int i = threadIdx.x; i < kTilePix * Q; i += kThreads) {
    const int p = i / Q;
    const int q = i - p * Q;
    const int gh = h0 + p / kTileP - 1;
    const int gp = pin0 + p % kTileP;
    int v = 0;
    if (gh >= 0 && gh < H && gp >= 0 && gp < P) {
      const int8_t* px = x + ((static_cast<long long>(n) * H + gh) * P + gp) * C;
      v = load_word(px, c0 + 4 * q, C, vec4);
    }
    dst[p * PS + q] = v;
  }
}

// Weights of the chunk as [tap][q][co], co fastest; tap = dy * 2 + v.
template <int Q>
__device__ void stage_weights(int* dst, const int8_t* __restrict__ w, int co0, int Co,
                              int C, int c0, bool vec4) {
  for (int i = threadIdx.x; i < kTaps * Q * kCoT; i += kThreads) {
    const int j = i % kCoT;
    const int t = i / kCoT;
    const int q = t % Q;
    const int tap = t / Q;
    const int co = co0 + j;
    dst[i] = co < Co
        ? load_word(w + (static_cast<long long>(co) * kTaps + tap) * C, c0 + 4 * q, C, vec4)
        : 0;
  }
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
qconv3x3_pair_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ a2, const float* __restrict__ bias2,
                     int H, int P, int C, int Co, int P_out, int delta, int n_co,
                     float inv, int relu, bool vec4, bool vec_out,
                     int8_t* __restrict__ out) {
  constexpr int PS = pixel_stride<Q>();
  __shared__ int tile[kTilePix * PS];
  __shared__ __align__(16) int wt[kTaps * Q * kCoT];

  const int n = blockIdx.z / n_co;
  const int co0 = (blockIdx.z % n_co) * kCoT;
  const int h0 = blockIdx.y * kTH;
  const int q0 = blockIdx.x * kTP;
  const int ty = threadIdx.x / kTP;
  const int tx = threadIdx.x % kTP;

  int acc[kCoT];
#pragma unroll
  for (int j = 0; j < kCoT; ++j) acc[j] = 0;

  for (int c0 = 0; c0 < C; c0 += 4 * Q) {
    stage_tile<Q>(tile, x, n, h0, q0 + delta, H, P, C, c0, vec4);
    stage_weights<Q>(wt, w, co0, Co, C, c0, vec4);
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int p = (ty + tap / 2) * kTileP + tx + tap % 2;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int xv = tile[p * PS + q];
        const int* wr = wt + (tap * Q + q) * kCoT;
#pragma unroll
        for (int j = 0; j < kCoT; ++j) acc[j] = __dp4a(xv, wr[j], acc[j]);
      }
    }
    __syncthreads();
  }

  const int h = h0 + ty;
  const int qo = q0 + tx;
  if (h >= H || qo >= P_out) return;
  const float lo = relu ? 0.0f : -127.0f;
  const int half = Co / 2;
  const bool to_a = delta != 0;  // a B input gives a phase-A output
  unsigned packed[kCoT / 4] = {};
#pragma unroll
  for (int j = 0; j < kCoT; ++j) {
    const int co = co0 + j;
    const float a = co < Co ? a2[co] : 0.0f;
    const float b = co < Co ? bias2[co] : 0.0f;
    float y = __fmaf_rn(__int2float_rn(acc[j]), a, b);
    if (relu) y = fmaxf(y, 0.0f);
    float r = fminf(fmaxf(rintf(__fmul_rn(y, inv)), lo), 127.0f);
    if (to_a && ((qo == 0 && co < half) || (qo == P_out - 1 && co >= half))) r = 0.0f;
    packed[j / 4] |= static_cast<unsigned>(static_cast<uint8_t>(__float2int_rn(r)))
                     << (8 * (j % 4));
  }
  int8_t* o = out + ((static_cast<long long>(n) * H + h) * P_out + qo) * Co + co0;
  if (vec_out) {
    *reinterpret_cast<int4*>(o) = make_int4(packed[0], packed[1], packed[2], packed[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kCoT; ++j) {
      if (co0 + j < Co) o[j] = static_cast<int8_t>(packed[j / 4] >> (8 * (j % 4)));
    }
  }
}

template <int Q>
void launch(const int8_t* x, const int8_t* w, const float* a2, const float* bias2, int N,
            int H, int P, int C, int Co, int P_out, int delta, float inv, int relu,
            bool vec4, bool vec_out, int8_t* out, cudaStream_t stream) {
  const int n_co = (Co + kCoT - 1) / kCoT;
  const dim3 grid((P_out + kTP - 1) / kTP, (H + kTH - 1) / kTH, N * n_co);
  qconv3x3_pair_kernel<Q><<<grid, kThreads, 0, stream>>>(
      x, w, a2, bias2, H, P, C, Co, P_out, delta, n_co, inv, relu, vec4, vec_out, out);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// x: (N, H, P, Cpk) int8 contiguous, phase A when in_phase_a != 0 (P odd) and
// phase B otherwise (P even); wp: (Co2, 3, 2, Cpk) int8 contiguous, Co2 even;
// a2, bias2: (Co2,) float32; out: (N, H, P_out, Co2) int8 contiguous with
// P_out = P - 1 from A and P + 1 from B; all on the device. out_inv =
// float32(127) / float32(out_scale); relu != 0 applies a ReLU.
extern "C" int twv_qconv3x3_pair_requant(const void* x, const void* wp, const void* a2,
                                         const void* bias2, int N, int H, int P,
                                         int Cpk, int Co2, int in_phase_a,
                                         float out_inv, int relu, void* out,
                                         void* stream) {
  if (N < 1 || H < 1 || P < 1 || Cpk < 1 || Co2 < 2 || Co2 % 2 ||
      P % 2 != (in_phase_a ? 1 : 0) || (in_phase_a && P < 3) ||
      N * ((Co2 + kCoT - 1) / kCoT) > 65535 || (H + kTH - 1) / kTH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int P_out = in_phase_a ? P - 1 : P + 1;
  const int delta = in_phase_a ? 0 : -1;
  const bool vec4 = Cpk % 4 == 0 && aligned(x, 4) && aligned(wp, 4);
  const bool vec_out = Co2 % kCoT == 0 && aligned(out, 16);
  const auto* xi = static_cast<const int8_t*>(x);
  const auto* wi = static_cast<const int8_t*>(wp);
  const auto* as = static_cast<const float*>(a2);
  const auto* b = static_cast<const float*>(bias2);
  auto* o = static_cast<int8_t*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int words = (Cpk + 3) / 4;
  if (words == 1) {
    launch<1>(xi, wi, as, b, N, H, P, Cpk, Co2, P_out, delta, out_inv, relu, vec4,
              vec_out, o, st);
  } else if (words == 2) {
    launch<2>(xi, wi, as, b, N, H, P, Cpk, Co2, P_out, delta, out_inv, relu, vec4,
              vec_out, o, st);
  } else if (words <= 4) {
    launch<4>(xi, wi, as, b, N, H, P, Cpk, Co2, P_out, delta, out_inv, relu, vec4,
              vec_out, o, st);
  } else {
    launch<8>(xi, wi, as, b, N, H, P, Cpk, Co2, P_out, delta, out_inv, relu, vec4,
              vec_out, o, st);
  }
  return static_cast<int>(cudaGetLastError());
}
