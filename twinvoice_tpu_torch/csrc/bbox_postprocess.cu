// K1 on Hopper: per-class bounding box of the pixels whose logit is above the
// class threshold.
//
// Replaces twinvoice_tpu/ops/pallas/postprocess.py:bbox_postprocess_pallas
// (Pallas kernel `_kernel`). Same contract: for image b and class c,
// boxes[b,c] = [x1,y1,x2,y2] are the inclusive min/max column and row of the
// pixels with logit > t_c (t_c in logit space), and valid[b,c] says whether
// there is any such pixel; with none the box is the sentinel (W, H, -1, -1).
// That equals the TPU kernel's any()-over-rows-and-columns form.
//
// Bound: every logit is read once and 17 bytes are written per
// (image, class), so the kernel is bound by device-memory bandwidth. At the
// serving shape (128 x 512 x 512 x 3 bf16 logits, 201 MB) the least time on an
// H100 SXM at 3.35 TB/s is about 60 us.
//
// Design: the TPU kernel holds one image in VMEM and runs a sequential grid
// over the batch. Here a 2-D grid cuts each image into `slices` bands of rows
// (enough blocks to fill every SM at any batch) and each block handles every
// class of its band at once, so it reads its band's bytes once. The main
// path's logits are NHWC-contiguous (the U-Net runs channels-last): there a
// thread takes 8 whole pixels in 16-byte loads, a warp reads one contiguous
// run, and each logit's class is known at compile time (scan_nhwc). Any other
// strides (an NCHW tensor viewed as NHWC, a slice) take scan_strided: one
// pixel per thread and step, neighbouring threads on neighbouring pixels.
// Each thread keeps four running min/max indices per class in registers. The
// block reduces them with warp shuffles and one pass through shared memory
// and writes its band's partial boxes; the last block of an image to finish
// (counted with one atomic per block) reduces the partials and writes the
// image's boxes.
//
// C interface for ctypes: twv_bbox_postprocess launches on the given stream
// and returns cudaGetLastError() as an int (0 = launched).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxClasses = 4;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

struct Thresholds {
  float v[kMaxClasses];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Box {
  int x1, y1, x2, y2;

  __device__ __forceinline__ void add(int w, int h) {
    x1 = min(x1, w);
    x2 = max(x2, w);
    y1 = min(y1, h);
    y2 = max(y2, h);
  }

  __device__ __forceinline__ void merge(int ox1, int oy1, int ox2, int oy2) {
    x1 = min(x1, ox1);
    y1 = min(y1, oy1);
    x2 = max(x2, ox2);
    y2 = max(y2, oy2);
  }

  __device__ __forceinline__ void warp_reduce() {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      merge(__shfl_xor_sync(0xffffffffu, x1, off), __shfl_xor_sync(0xffffffffu, y1, off),
            __shfl_xor_sync(0xffffffffu, x2, off), __shfl_xor_sync(0xffffffffu, y2, off));
    }
  }
};

// Any strides: one pixel per thread and step, its C logits read through sC;
// kUnroll pixels' loads are issued before any is compared.
template <typename T>
__device__ __forceinline__ void scan_strided(const T* img, int h0, int n, int W,
                                             int C, long long sH, long long sW,
                                             long long sC, const Thresholds& thr,
                                             Box (&box)[kMaxClasses]) {
  for (int base = threadIdx.x; base < n; base += kThreads * kUnroll) {
    float v[kUnroll][kMaxClasses];
    int hh[kUnroll], ww[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      hh[u] = -1;
      ww[u] = 0;
      if (i < n) {
        const int r = i / W;
        hh[u] = h0 + r;
        ww[u] = i - r * W;
        const T* px = img + hh[u] * sH + ww[u] * sW;
#pragma unroll
        for (int c = 0; c < kMaxClasses; ++c) {
          v[u][c] = c < C ? to_float(px[c * sC]) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (hh[u] < 0) continue;
#pragma unroll
      for (int c = 0; c < kMaxClasses; ++c) {
        if (c < C && v[u][c] > thr.v[c]) box[c].add(ww[u], hh[u]);
      }
    }
  }
}

// NHWC-contiguous band (the channels-last U-Net's logits): a thread takes 8
// whole pixels, 8 * CT logits in CT * sizeof(T) / 2 aligned 16-byte loads,
// so a warp reads one contiguous run; the class of each logit is known at
// compile time. Needs W % 8 == 0 (8 pixels never straddle a row).
template <typename T, int CT>
__device__ __forceinline__ void scan_nhwc(const T* band, int h0, int n, int W,
                                          const Thresholds& thr,
                                          Box (&box)[kMaxClasses]) {
  constexpr int kPix = 8;
  constexpr int kElems = kPix * CT;
  constexpr int kVecs = kElems * static_cast<int>(sizeof(T)) / 16;
  const uint4* src = reinterpret_cast<const uint4*>(band);
  for (int g = threadIdx.x; g < n / kPix; g += kThreads) {
    uint4 raw[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) raw[k] = __ldg(src + g * kVecs + k);
    const T* e = reinterpret_cast<const T*>(raw);
    const int p0 = g * kPix;
    const int r = p0 / W;
    const int h = h0 + r;
    const int w0 = p0 - r * W;
#pragma unroll
    for (int k = 0; k < kElems; ++k) {
      if (to_float(e[k]) > thr.v[k % CT]) box[k % CT].add(w0 + k / CT, h);
    }
  }
}

// grid (slices, B); block (s, b) handles rows [s * rows, (s + 1) * rows) of
// image b. partial: (B, slices, C, 4) int32 scratch; done: (B,) uint32, zero
// before the launch. CT > 0: NHWC-contiguous with C == CT (scan_nhwc);
// CT == 0: any strides (scan_strided).
template <typename T, int CT>
__global__ void __launch_bounds__(kThreads)
bbox_kernel(const T* __restrict__ x, int H, int W, int C, long long sB,
            long long sH, long long sW, long long sC, int rows, Thresholds thr,
            int* __restrict__ partial, unsigned int* __restrict__ done,
            int* __restrict__ boxes, unsigned char* __restrict__ valid) {
  const int s = blockIdx.x;
  const int slices = gridDim.x;
  const int b = blockIdx.y;
  const int h0 = s * rows;
  const int n = max(0, min(H, h0 + rows) - h0) * W;  // pixels in this band
  const T* img = x + b * sB;
  const Box empty{W, H, -1, -1};

  Box box[kMaxClasses];
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) box[c] = empty;
  if constexpr (CT > 0) {
    scan_nhwc<T, CT>(img + h0 * sH, h0, n, W, thr, box);
  } else {
    scan_strided<T>(img, h0, n, W, C, sH, sW, sC, thr, box);
  }

  __shared__ Box warp_box[kWarps][kMaxClasses];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) {
    box[c].warp_reduce();
    if (lane == 0) warp_box[warp][c] = box[c];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) {
      Box r = lane < kWarps ? warp_box[lane][c] : empty;
      r.warp_reduce();
      if (lane == 0 && c < C) {
        int* p = partial + ((b * slices + s) * C + c) * 4;
        p[0] = r.x1;
        p[1] = r.y1;
        p[2] = r.x2;
        p[3] = r.y2;
      }
    }
  }
  if (threadIdx.x == 0) {
    __threadfence();  // this block's partials are visible before it is counted
    last = atomicAdd(done + b, 1u) == static_cast<unsigned int>(slices - 1);
  }
  __syncthreads();
  if (last && threadIdx.x < C) {  // every band of image b is in: reduce them
    const int c = threadIdx.x;
    Box r = empty;
    for (int t = 0; t < slices; ++t) {
      const int* p = partial + ((b * slices + t) * C + c) * 4;
      r.merge(__ldcg(p), __ldcg(p + 1), __ldcg(p + 2), __ldcg(p + 3));
    }
    int* out = boxes + (b * C + c) * 4;  // (B, C, 4) contiguous
    out[0] = r.x1;
    out[1] = r.y1;
    out[2] = r.x2;
    out[3] = r.y2;
    valid[b * C + c] = r.y2 >= 0;
  }
}

template <typename T>
void launch(const void* x, int B, int H, int W, int C, long long sB,
            long long sH, long long sW, long long sC, int slices, int rows,
            const Thresholds& thr, int* partial, unsigned int* done, int* boxes,
            unsigned char* valid, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const dim3 grid(slices, B);
  const bool nhwc3 = C == 3 && sC == 1 && sW == 3 && sH == 3LL * W && W % 8 == 0 &&
                     (sB * static_cast<long long>(sizeof(T))) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (nhwc3) {
    bbox_kernel<T, 3><<<grid, kThreads, 0, stream>>>(
        xt, H, W, C, sB, sH, sW, sC, rows, thr, partial, done, boxes, valid);
  } else {
    bbox_kernel<T, 0><<<grid, kThreads, 0, stream>>>(
        xt, H, W, C, sB, sH, sW, sC, rows, thr, partial, done, boxes, valid);
  }
}

}  // namespace

// x: logits (B, H, W, C) addressed through element strides sB, sH, sW, sC;
// float32 when is_bf16 == 0, bfloat16 otherwise. thresholds: C host floats,
// in logit space. Each image is cut into `slices` bands of `rows` rows
// (slices * rows >= H). partial: (B, slices, C, 4) int32 scratch; done: (B,)
// int32 zeroed before the call; boxes: (B, C, 4) int32; valid: (B, C) bytes;
// all on the device, the last three contiguous.
extern "C" int twv_bbox_postprocess(const void* x, int is_bf16, int B, int H,
                                    int W, int C, long long sB, long long sH,
                                    long long sW, long long sC, int slices,
                                    int rows, const float* thresholds,
                                    void* partial, void* done, void* boxes,
                                    void* valid, void* stream) {
  if (B < 1 || B > 65535 || H < 0 || W < 0 || C < 1 || C > kMaxClasses ||
      slices < 1 || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Thresholds thr{};
  for (int c = 0; c < C; ++c) thr.v[c] = thresholds[c];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* pt = static_cast<int*>(partial);
  unsigned int* dn = static_cast<unsigned int*>(done);
  int* bx = static_cast<int*>(boxes);
  unsigned char* vd = static_cast<unsigned char*>(valid);
  if (is_bf16) {
    launch<__nv_bfloat16>(x, B, H, W, C, sB, sH, sW, sC, slices, rows, thr, pt, dn, bx, vd, st);
  } else {
    launch<float>(x, B, H, W, C, sB, sH, sW, sC, slices, rows, thr, pt, dn, bx, vd, st);
  }
  return static_cast<int>(cudaGetLastError());
}
