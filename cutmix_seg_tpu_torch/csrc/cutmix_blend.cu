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
// Bound: pure memory traffic, with no reuse. At the main-path shape
// (10 x 321 x 321 x 3, one box) it reads x0 and x1 and writes out and the mask
// once: 41.22 MB in f32 (3 x 12.36 MB + 4.12 MB), 12.3 us at 3.35 TB/s, and
// 20.61 MB in bf16, 6.15 us. There is no product and nothing is read twice, so
// wgmma, clusters and TMA tiles have nothing to work on; the only lever is how
// the HBM stream is issued. The ALU has room to spare (about 240 f32
// operations per 12 bytes moved before it bounds the kernel), so the design
// spends arithmetic to keep the stream dense:
//  1. One flat stream. x0, x1 and out are read as one run of N*H*W*C elements
//     and the mask as one run of N*H*W, in 16-byte vectors (4 f32 or 8 bf16);
//     lane l of a warp takes vector base + l, so a warp instruction moves 512
//     contiguous bytes. No per-sample grid: the batch has no limit beyond
//     2^31 - 1 elements per tensor (32-bit indices, checked by the launcher).
//  2. Bytes in flight. Each thread issues the loads of kUnroll = 2 vectors
//     of x0 and x1 (64 bytes) before any arithmetic; they are streaming loads
//     (__ldcs: read once, evict first). Stores are ordinary, since the step
//     reads out and the mask right after. The grid is what the card holds at
//     once (occupancy x SMs), over a grid-stride loop of tiles: no partial
//     last wave of short blocks. Four vectors a thread spill registers in
//     bf16 and run slower; so does a loop that loads its next tile before it
//     blends the current one.
//  3. No block barrier. A thread finds a vector's first pixel from its flat
//     index (multiply-shift division by C, W and H*W), reads its sample's
//     rects through the read-only path (16 bytes a box, resident in L1),
//     resolves them in registers and turns each box into a range of mask
//     bits over the vector; a vector that crosses a row, or a sample, does
//     so for each of its two rows. No lane loops over its elements, which
//     would hold up its whole warp: with 8-element vectors most mask warps
//     hold a lane that crosses a 321-pixel row.
//  4. Ragged edges in the same launch: the last block does the elements
//     after the last whole vector one by one; if any pointer is not 16-byte
//     aligned (a view at an odd offset), the launcher runs the one-element
//     variant of the same kernel instead.
//  5. One launch per call, the image and mask streams as tiles of one loop.
//
// The blend keeps the arithmetic form x0 * (1 - m) + x1 * m (not a select), so
// NaN and Inf propagate as in the reference. Since m is 0 or 1, every product
// and sum is exact, so computing in float and rounding to bf16 once gives the
// same bits as bf16 arithmetic.
//
// C interface (ctypes): each entry launches on `stream` and returns a
// cudaError_t as an int, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;                     // per SM: at most 64 registers
constexpr int kUnroll = 2;                        // vectors per thread per tile
constexpr unsigned kTileVecs = kThreads * kUnroll;

// q = n / d for n, d < 2^31 by multiply and shift (Granlund-Montgomery).
struct FastDiv {
  unsigned m, s;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

FastDiv make_div(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned m = static_cast<unsigned>(((1ull << 32) * ((1ull << s) - d)) / d + 1);
  return {m, s};
}

struct Params {
  const void* x0;
  const void* x1;
  const float* rects;
  void* out;
  void* mask;
  unsigned n_elems, n_pix;      // N*H*W*C and N*H*W
  unsigned img_vecs, mask_vecs;  // whole vectors in each stream
  unsigned img_tiles, tiles;    // image tiles, then mask tiles
  int h, w, c, n_boxes, base;
  FastDiv div_c, div_w, div_hw;
};

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

// V elements of T, moved as one access of the unsigned type of that size.
template <int Bytes> struct RawOf;
template <> struct RawOf<2> { using type = unsigned short; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<16> { using type = uint4; };

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  using Raw = typename RawOf<sizeof(T) * V>::type;
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_stream(const void* base, size_t i) {
  using Raw = typename Pack<T, V>::Raw;
  const Raw r = __ldcs(static_cast<const Raw*>(base) + i);
  Pack<T, V> p;
  memcpy(&p, &r, sizeof(r));
  return p;
}

template <typename T, int V>
__device__ __forceinline__ void store(void* base, size_t i, const Pack<T, V>& p) {
  using Raw = typename Pack<T, V>::Raw;
  Raw r;
  memcpy(&r, &p, sizeof(r));
  static_cast<Raw*>(base)[i] = r;
}

// NumPy-slice resolution of one coordinate (float -> int truncates toward zero
// like jnp.trunc).
__device__ __forceinline__ int resolve(float v, int size) {
  int i = static_cast<int>(v);
  if (i < 0) i += size;
  return min(max(i, 0), size);
}

struct Box {
  int y0, x0, y1, x1;
};

// Box b of sample n, read through the read-only path and resolved.
__device__ __forceinline__ Box load_box(const Params& p, unsigned n, int b) {
  const float* r = p.rects + (static_cast<size_t>(n) * p.n_boxes + b) * 4;
  return {resolve(__ldg(r), p.h), resolve(__ldg(r + 1), p.w),
          resolve(__ldg(r + 2), p.h), resolve(__ldg(r + 3), p.w)};
}

// The mask bit of pixel (y, x) of sample n.
__device__ __forceinline__ unsigned pixel_bit(const Params& p, unsigned n, int y, int x) {
  unsigned t = p.base;
  for (int b = 0; b < p.n_boxes; ++b) {
    const Box k = load_box(p, n, b);
    t ^= static_cast<unsigned>((y >= k.y0) & (y < k.y1) & (x >= k.x0) & (x < k.x1));
  }
  return t;
}

// Bits of the elements k in [klo, khi) that lie in row y of sample n, with
// element k at column (k - off) / c: base XOR each box that covers the row
// toggles the elements k in [off + c x0, off + c x1). Each box is read once.
__device__ __forceinline__ unsigned row_bits(const Params& p, unsigned n, int y, int off,
                                             int klo, int khi, int c) {
  unsigned bits = p.base ? (1u << khi) - (1u << klo) : 0u;
  for (int b = 0; b < p.n_boxes; ++b) {
    const Box k = load_box(p, n, b);
    const int lo = max(off + c * k.x0, klo), hi = min(off + c * k.x1, khi);
    if (y >= k.y0 && y < k.y1 && lo < hi) bits ^= (1u << hi) - (1u << lo);
  }
  return bits;
}

// Mask bits of V consecutive elements from flat index e0 of a stream with
// `c` elements per pixel (C for the images, 1 for the mask), bit k for
// element k. A vector lies in one row, or, where it crosses a row (or a
// sample: H*W*C is odd at the main shape, so sample boundaries fall inside
// vectors), in the tail of one row and the head of the next; each part takes
// row_bits. Rows shorter than a vector are tested element by element.
template <int V>
__device__ __forceinline__ unsigned vector_bits(const Params& p, unsigned e0, int c,
                                                const FastDiv& div_c) {
  const unsigned pix = div_c.div(e0);
  const int cs = static_cast<int>(e0 - pix * c);
  const unsigned n = p.div_hw.div(pix);
  const unsigned r = pix - n * static_cast<unsigned>(p.h * p.w);
  const int y = static_cast<int>(p.div_w.div(r));
  const int xs = static_cast<int>(r) - y * p.w;
  const int off = -(xs * c + cs);       // element k lies at column (k - off) / c
  const int left = p.w * c + off;      // elements from e0 to the end of its row
  if (left >= V) return row_bits(p, n, y, off, 0, V, c);
  if (p.w * c >= V) {
    const bool last_row = y + 1 == p.h;
    return row_bits(p, n, y, off, 0, left, c) |
           row_bits(p, last_row ? n + 1 : n, last_row ? 0 : y + 1, left, left, V, c);
  }
  unsigned bits = 0;
#pragma unroll 1
  for (int k = 0; k < V; ++k) {
    const unsigned pk = div_c.div(e0 + k);
    const unsigned nk = p.div_hw.div(pk);
    const unsigned rk = pk - nk * static_cast<unsigned>(p.h * p.w);
    const int yk = static_cast<int>(p.div_w.div(rk));
    bits |= pixel_bit(p, nk, yk, static_cast<int>(rk) - yk * p.w) << k;
  }
  return bits;
}

template <typename T, int V>
__device__ __forceinline__ void blend_vector(const Params& p, unsigned i,
                                             const Pack<T, V>& a, const Pack<T, V>& b) {
  const unsigned bits = vector_bits<V>(p, i * V, p.c, p.div_c);
  Pack<T, V> o;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float m = (bits >> k) & 1u ? 1.0f : 0.0f;
    o.v[k] = from_float<T>(to_float(a.v[k]) * (1.0f - m) + to_float(b.v[k]) * m);
  }
  store<T, V>(p.out, i, o);
}

template <typename T, int V>
__device__ __forceinline__ void mask_vector(const Params& p, unsigned i) {
  const unsigned bits = vector_bits<V>(p, i * V, 1, FastDiv{1, 0});
  Pack<T, V> o;
#pragma unroll
  for (int k = 0; k < V; ++k) o.v[k] = from_float<T>((bits >> k) & 1u ? 1.0f : 0.0f);
  store<T, V>(p.mask, i, o);
}

// V = 16 / sizeof(T) elements per access, or 1 for unaligned pointers.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cutmix_blend_kernel(const Params p) {
  for (unsigned tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    if (tile < p.img_tiles) {
      const unsigned first = tile * kTileVecs + threadIdx.x;
      Pack<T, V> a[kUnroll], b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // every load before any arithmetic
        const unsigned i = first + u * kThreads;
        if (i < p.img_vecs) {
          a[u] = load_stream<T, V>(p.x0, i);
          b[u] = load_stream<T, V>(p.x1, i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned i = first + u * kThreads;
        if (i < p.img_vecs) blend_vector<T, V>(p, i, a[u], b[u]);
      }
    } else {
      const unsigned first = (tile - p.img_tiles) * kTileVecs + threadIdx.x;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned i = first + u * kThreads;
        if (i < p.mask_vecs) mask_vector<T, V>(p, i);
      }
    }
  }
  // the ragged ends: fewer than V elements left after each stream's last vector
  if (V > 1 && blockIdx.x == gridDim.x - 1) {
    const unsigned e = p.img_vecs * V + threadIdx.x;
    if (e < p.n_elems) {
      blend_vector<T, 1>(p, e, load_stream<T, 1>(p.x0, e), load_stream<T, 1>(p.x1, e));
    }
    const unsigned q = p.mask_vecs * V + threadIdx.x;
    if (q < p.n_pix) mask_vector<T, 1>(p, q);
  }
}

template <typename T, int V>
cudaError_t launch_variant(const Params& p, cudaStream_t stream) {
  static int blocks_per_sm = 0;  // a property of the kernel, not the card
  cudaError_t err;
  if (blocks_per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, cutmix_blend_kernel<T, V>, kThreads, 0);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  const unsigned resident = static_cast<unsigned>(blocks_per_sm * sms);
  const unsigned grid = p.tiles < resident ? p.tiles : resident;
  cutmix_blend_kernel<T, V><<<grid > 0 ? grid : 1, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x0, const void* x1, const void* rects, void* out,
           void* mask, int n, int h, int w, int c, int n_boxes, int invert,
           void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long pix = static_cast<long long>(n) * h * w;
  const long long elems = pix * c;
  if (n < 1 || h < 1 || w < 1 || c < 1 || n_boxes < 1 || elems > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.x0 = x0;
  p.x1 = x1;
  p.rects = static_cast<const float*>(rects);
  p.out = out;
  p.mask = mask;
  p.n_elems = static_cast<unsigned>(elems);
  p.n_pix = static_cast<unsigned>(pix);
  p.h = h;
  p.w = w;
  p.c = c;
  p.n_boxes = n_boxes;
  p.base = invert ? 0 : 1;
  p.div_c = make_div(c);
  p.div_w = make_div(w);
  p.div_hw = make_div(static_cast<unsigned>(h) * w);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x0) | reinterpret_cast<uintptr_t>(x1) |
                         reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(mask);
  const int v = addr % 16 == 0 ? kVec : 1;
  p.img_vecs = p.n_elems / v;
  p.mask_vecs = p.n_pix / v;
  p.img_tiles = (p.img_vecs + kTileVecs - 1) / kTileVecs;
  p.tiles = p.img_tiles + (p.mask_vecs + kTileVecs - 1) / kTileVecs;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(v == kVec ? launch_variant<T, kVec>(p, s) : launch_variant<T, 1>(p, s));
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
