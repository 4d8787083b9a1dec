// Native image decoder for the host data loader.
//
// The reference implementation leans on PIL inside torch DataLoader worker
// *processes* for all image decoding (reference: datapipe/seg_data.py:15-109,
// datapipe/pascal_voc_dataset.py:18-29).  This framework's loader is
// single-process and threaded (data/loader.py); Python-side PIL decoding
// works but serialises part of each decode under the GIL and pays
// PIL-object/numpy-conversion overhead per image.  This C++ component decodes
// PNG (libpng) and JPEG (libjpeg-turbo) directly into caller-provided numpy
// buffers, releases no Python state, and is fully parallel across loader
// threads (ctypes foreign calls drop the GIL).
//
// Parity contract: the output equals `np.array(PIL.Image.open(bytes))` for
// the supported subset --
//   PNG:  8-bit gray (H,W), gray+alpha (H,W,2), palette indices (H,W)
//         (palette is NOT expanded -- PIL's np.array on mode-P images yields
//         raw indices, which is exactly what the label pipeline needs),
//         RGB (H,W,3), RGBA (H,W,4); interlaced OK; <8-bit palette unpacked
//         to one index per byte.
//   JPEG: 8-bit grayscale (H,W) and RGB (H,W,3) baseline/progressive.
// Everything else (16-bit, 1-bit bool, CMYK, ...) returns UNSUPPORTED and the
// Python wrapper falls back to PIL.
//
// API (ctypes, all returns: 0 ok / negative error):
//   cutmix_decode_probe(buf, len, &h, &w, &channels)
//   cutmix_decode(buf, len, out /* h*w*channels bytes, caller-allocated */)
//   cutmix_encode_png(pixels, h, w, channels, bit_depth, &out, &out_len)
//     + cutmix_free(out)  -- prediction-export writer (8-bit gray/RGB,
//     16-bit gray; mirrors PIL's mode-L/RGB/I PNG output content)

#include <csetjmp>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#include <png.h>

#include <cstdio>  // jpeglib needs FILE
#include <jerror.h>
#include <jpeglib.h>

namespace {

constexpr int kOk = 0;
constexpr int kErrBadData = -1;      // not a PNG/JPEG or corrupt stream
constexpr int kErrUnsupported = -2;  // valid image outside the parity subset
constexpr int kErrInternal = -3;

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

struct PngReadState {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

void png_read_from_memory(png_structp png, png_bytep out, png_size_t count) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + count > s->len) {
    png_error(png, "read past end of buffer");
    return;
  }
  std::memcpy(out, s->data + s->pos, count);
  s->pos += count;
}

void png_on_error(png_structp png, png_const_charp) {
  std::longjmp(*static_cast<std::jmp_buf*>(png_get_error_ptr(png)), 1);
}

void png_on_warning(png_structp, png_const_charp) {}

struct PngInfoOut {
  png_uint_32 h, w;
  int channels;
};

// Shared open-and-configure: applies the PIL-parity transforms and reads the
// updated geometry. Returns kOk with *png/*info live (caller must destroy),
// or an error (already destroyed).
int png_open(const uint8_t* buf, size_t len, std::jmp_buf* jb,
             png_structp* png_out, png_infop* info_out, PngReadState* state,
             PngInfoOut* out) {
  if (len < 8 || png_sig_cmp(buf, 0, 8) != 0) return kErrBadData;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, jb,
                                           png_on_error, png_on_warning);
  if (!png) return kErrInternal;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return kErrInternal;
  }
  if (setjmp(*jb)) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrBadData;
  }
  state->data = buf;
  state->len = len;
  state->pos = 0;
  png_set_read_fn(png, state, png_read_from_memory);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);

  int channels;
  if (color == PNG_COLOR_TYPE_PALETTE) {
    // PIL keeps mode P as raw indices; unpack sub-byte indices to one/byte.
    if (depth > 8) {
      png_destroy_read_struct(&png, &info, nullptr);
      return kErrUnsupported;
    }
    if (depth < 8) png_set_packing(png);
    channels = 1;
  } else {
    // PIL maps 1-bit gray to bool and 16-bit to uint16 -- out of scope.
    if (depth != 8) {
      png_destroy_read_struct(&png, &info, nullptr);
      return kErrUnsupported;
    }
    switch (color) {
      case PNG_COLOR_TYPE_GRAY: channels = 1; break;
      case PNG_COLOR_TYPE_GRAY_ALPHA: channels = 2; break;
      case PNG_COLOR_TYPE_RGB: channels = 3; break;
      case PNG_COLOR_TYPE_RGB_ALPHA: channels = 4; break;
      default:
        png_destroy_read_struct(&png, &info, nullptr);
        return kErrUnsupported;
    }
  }
  png_read_update_info(png, info);
  if (png_get_rowbytes(png, info) != static_cast<size_t>(w) * channels) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrInternal;
  }
  out->h = h;
  out->w = w;
  out->channels = channels;
  *png_out = png;
  *info_out = info;
  return kOk;
}

int png_probe(const uint8_t* buf, size_t len, int* h, int* w, int* channels) {
  std::jmp_buf jb;
  png_structp png;
  png_infop info;
  PngReadState state;
  PngInfoOut geo;
  int rc = png_open(buf, len, &jb, &png, &info, &state, &geo);
  if (rc != kOk) return rc;
  png_destroy_read_struct(&png, &info, nullptr);
  *h = static_cast<int>(geo.h);
  *w = static_cast<int>(geo.w);
  *channels = geo.channels;
  return kOk;
}

int png_decode(const uint8_t* buf, size_t len, uint8_t* out) {
  std::jmp_buf jb;
  png_structp png;
  png_infop info;
  PngReadState state;
  PngInfoOut geo;
  int rc = png_open(buf, len, &jb, &png, &info, &state, &geo);
  if (rc != kOk) return rc;
  // volatile: assigned between setjmp and a possible longjmp from libpng
  // (corrupt IDAT); freed on both paths.
  png_bytep* volatile rows = nullptr;
  if (setjmp(jb)) {
    delete[] rows;
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrBadData;
  }
  size_t stride = static_cast<size_t>(geo.w) * geo.channels;
  // png_read_image handles interlacing internally given all row pointers.
  rows = new png_bytep[geo.h];
  for (png_uint_32 y = 0; y < geo.h; ++y) rows[y] = out + y * stride;
  png_read_image(png, rows);
  png_read_end(png, nullptr);
  delete[] rows;
  rows = nullptr;
  png_destroy_read_struct(&png, &info, nullptr);
  return kOk;
}

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jb;
};

void jpeg_on_error(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  std::longjmp(err->jb, 1);
}

void jpeg_no_output(j_common_ptr, int) {}

bool looks_like_jpeg(const uint8_t* buf, size_t len) {
  return len >= 3 && buf[0] == 0xFF && buf[1] == 0xD8 && buf[2] == 0xFF;
}

int jpeg_run(const uint8_t* buf, size_t len, int* h, int* w, int* channels,
             uint8_t* out) {
  if (!looks_like_jpeg(buf, len)) return kErrBadData;
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_on_error;
  err.mgr.emit_message = jpeg_no_output;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return kErrBadData;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);

  // PIL parity: grayscale stays grayscale, everything else decodes to RGB
  // except CMYK/YCCK which PIL handles with its own inversion logic.
  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    jpeg_destroy_decompress(&cinfo);
    return kErrUnsupported;
  }
  int ch = (cinfo.jpeg_color_space == JCS_GRAYSCALE) ? 1 : 3;
  cinfo.out_color_space = (ch == 1) ? JCS_GRAYSCALE : JCS_RGB;

  if (out == nullptr) {  // probe
    *h = static_cast<int>(cinfo.image_height);
    *w = static_cast<int>(cinfo.image_width);
    *channels = ch;
    jpeg_destroy_decompress(&cinfo);
    return kOk;
  }

  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_components) != ch) {
    jpeg_destroy_decompress(&cinfo);
    return kErrInternal;
  }
  size_t stride = static_cast<size_t>(cinfo.output_width) * ch;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return kOk;
}

bool looks_like_png(const uint8_t* buf, size_t len) {
  return len >= 8 && png_sig_cmp(buf, 0, 8) == 0;
}

// ---------------------------------------------------------------------------
// PNG encode (prediction export: 8-bit gray/RGB and 16-bit gray label maps)
// ---------------------------------------------------------------------------

struct PngWriteState {
  uint8_t* data;
  size_t len;
  size_t cap;
};

void png_write_to_memory(png_structp png, png_bytep in, png_size_t count) {
  PngWriteState* s = static_cast<PngWriteState*>(png_get_io_ptr(png));
  if (s->len + count > s->cap) {
    size_t cap = s->cap ? s->cap : 4096;
    while (cap < s->len + count) cap *= 2;
    uint8_t* grown = static_cast<uint8_t*>(std::realloc(s->data, cap));
    if (!grown) {
      png_error(png, "out of memory");
      return;
    }
    s->data = grown;
    s->cap = cap;
  }
  std::memcpy(s->data + s->len, in, count);
  s->len += count;
}

void png_flush_noop(png_structp) {}

int png_encode(const uint8_t* pixels, int h, int w, int channels,
               int bit_depth, uint8_t** out, size_t* out_len) {
  if (h <= 0 || w <= 0) return kErrBadData;
  if (!((bit_depth == 8 && (channels == 1 || channels == 3)) ||
        (bit_depth == 16 && channels == 1)))
    return kErrUnsupported;
  std::jmp_buf jb;
  png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING, &jb,
                                            png_on_error, png_on_warning);
  if (!png) return kErrInternal;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    return kErrInternal;
  }
  PngWriteState state{nullptr, 0, 0};
  png_bytep* volatile rows = nullptr;
  if (setjmp(jb)) {
    delete[] rows;
    std::free(state.data);
    png_destroy_write_struct(&png, &info);
    return kErrInternal;
  }
  png_set_write_fn(png, &state, png_write_to_memory, png_flush_noop);
  png_set_IHDR(png, info, w, h, bit_depth,
               channels == 3 ? PNG_COLOR_TYPE_RGB : PNG_COLOR_TYPE_GRAY,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  if (bit_depth == 16) png_set_swap(png);  // caller passes native little-endian
  size_t stride = static_cast<size_t>(w) * channels * (bit_depth / 8);
  rows = new png_bytep[h];
  for (int y = 0; y < h; ++y)
    rows[y] = const_cast<png_bytep>(pixels + y * stride);
  png_write_image(png, rows);
  png_write_end(png, nullptr);
  delete[] rows;
  rows = nullptr;
  png_destroy_write_struct(&png, &info);
  *out = state.data;
  *out_len = state.len;
  return kOk;
}

}  // namespace

extern "C" {

int cutmix_decode_probe(const uint8_t* buf, size_t len, int* h, int* w,
                        int* channels) {
  if (looks_like_png(buf, len)) return png_probe(buf, len, h, w, channels);
  if (looks_like_jpeg(buf, len))
    return jpeg_run(buf, len, h, w, channels, nullptr);
  return kErrBadData;
}

int cutmix_decode(const uint8_t* buf, size_t len, uint8_t* out) {
  if (looks_like_png(buf, len)) return png_decode(buf, len, out);
  if (looks_like_jpeg(buf, len)) {
    int h, w, c;
    return jpeg_run(buf, len, &h, &w, &c, out);
  }
  return kErrBadData;
}

// PNG encode into a malloc'd buffer; caller must call cutmix_free(*out).
// bit_depth 8 (channels 1 or 3) or 16 (channels 1, native-endian uint16).
int cutmix_encode_png(const uint8_t* pixels, int h, int w, int channels,
                      int bit_depth, uint8_t** out, size_t* out_len) {
  return png_encode(pixels, h, w, channels, bit_depth, out, out_len);
}

void cutmix_free(uint8_t* ptr) { std::free(ptr); }

// Version tag so the Python wrapper can confirm it loaded the library it
// just built (guards against stale cached .so files).
int cutmix_decode_abi_version() { return 2; }

}  // extern "C"
