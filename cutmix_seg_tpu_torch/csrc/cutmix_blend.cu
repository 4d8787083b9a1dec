// Fused box-mask rasterisation + CutMix blend, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cutmix_seg_tpu/ops/pallas_cutmix.py::_blend_kernel
// (launched by cutmix_blend's pl.pallas_call). Per sample n and pixel (y, x):
//   t = XOR over boxes of [y0 <= y < y1 and x0 <= x < x1], starting from
//       base = 0 (invert) or 1, with each rect coordinate resolved like a NumPy
//       slice index (truncate toward zero, negative += size, clamp to [0, size]);
//   mask[n, y, x]    = t
//   out[n, y, x, :]  = x0 * (1 - t) + x1 * t
// over NHWC-contiguous tensors; the mask is written in the images' type.
//
// Bound: pure memory traffic. At the main-path shape (10 x 321 x 321 x 3, f32,
// one box) it reads 2 x 12.36 MB and writes 12.36 MB + 4.12 MB of mask,
// 41.2 MB, about 12.3 us at 3.35 TB/s; 20.6 MB in bf16. The design does nothing
// beyond touching each byte once: one thread per pixel, the block's sample's
// rects resolved once into shared memory, the box test done once per pixel and
// reused for its C channels. The TPU kernel's (N, H, W*C) lane fold existed
// for the 128-lane VMEM tile and is not carried over.
//
// The blend keeps the arithmetic form x0 * (1 - m) + x1 * m (not a select), so
// NaN and Inf propagate as in the reference. Since m is 0 or 1, every product
// and sum is exact, so computing in float and rounding to bf16 once gives the
// same bits as bf16 arithmetic.
//
// C interface (ctypes): each entry launches on `stream` and returns
// cudaGetLastError() as an int, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// NumPy-slice resolution of one coordinate (float -> int truncates toward zero
// like jnp.trunc).
__device__ __forceinline__ int resolve(float v, int size) {
  int i = static_cast<int>(v);
  if (i < 0) i += size;
  return min(max(i, 0), size);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cutmix_blend_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
                    const float* __restrict__ rects, T* __restrict__ out,
                    T* __restrict__ mask, int h, int w, int c, int n_boxes,
                    int base) {
  extern __shared__ int box[];  // n_boxes x (y0, x0, y1, x1), resolved
  const int n = blockIdx.y;
  for (int i = threadIdx.x; i < 4 * n_boxes; i += blockDim.x) {
    // coordinate order y0, x0, y1, x1 -> sizes h, w, h, w
    box[i] = resolve(rects[static_cast<size_t>(n) * 4 * n_boxes + i], (i & 1) ? w : h);
  }
  __syncthreads();

  const int hw = h * w;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const int y = p / w;
  const int x = p - y * w;
  int t = base;
  for (int b = 0; b < n_boxes; ++b) {
    const int* r = box + 4 * b;
    t ^= static_cast<int>((y >= r[0]) & (y < r[2]) & (x >= r[1]) & (x < r[3]));
  }
  const float m = static_cast<float>(t);
  const size_t pix = static_cast<size_t>(n) * hw + p;
  mask[pix] = from_float<T>(m);
  const T* a = x0 + pix * c;
  const T* b = x1 + pix * c;
  T* o = out + pix * c;
  for (int k = 0; k < c; ++k) {
    o[k] = from_float<T>(to_float(a[k]) * (1.0f - m) + to_float(b[k]) * m);
  }
}

template <typename T>
int launch(const void* x0, const void* x1, const void* rects, void* out,
           void* mask, int n, int h, int w, int c, int n_boxes, int invert,
           void* stream) {
  const dim3 grid((h * w + kThreads - 1) / kThreads, n);
  const size_t smem = sizeof(int) * 4 * static_cast<size_t>(n_boxes);
  cutmix_blend_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x0), static_cast<const T*>(x1),
      static_cast<const float*>(rects), static_cast<T*>(out), static_cast<T*>(mask),
      h, w, c, n_boxes, invert ? 0 : 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cutmix_blend_f32(const void* x0, const void* x1, const void* rects,
                                void* out, void* mask, int n, int h, int w, int c,
                                int n_boxes, int invert, void* stream) {
  return launch<float>(x0, x1, rects, out, mask, n, h, w, c, n_boxes, invert, stream);
}

extern "C" int cutmix_blend_bf16(const void* x0, const void* x1, const void* rects,
                                 void* out, void* mask, int n, int h, int w, int c,
                                 int n_boxes, int invert, void* stream) {
  return launch<__nv_bfloat16>(x0, x1, rects, out, mask, n, h, w, c, n_boxes, invert,
                               stream);
}
