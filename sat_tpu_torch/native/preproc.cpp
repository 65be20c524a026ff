// The port's host-side image loader: a C++ library bound with ctypes by
// sat_tpu_torch/data/native.py, which builds it with g++ at first use.
// It is not a CUDA kernel: it runs on the host and feeds the encoder.
//
// Two tiers:
//
//  1. resize_normalize: bilinear resize of a decoded RGB image to the model
//     resolution plus ImageNet normalization, fused in one pass over the
//     output (the PIL path materializes the resized uint8 image, a float
//     [0,1] copy and the normalized copy; the reference's torchvision
//     transforms, train.py:27-32, do the same in three steps).
//  2. load_resize_normalize[_batch]: the whole file -> tensor path, read +
//     JPEG/PNG decode (libjpeg/libpng, gated on header presence at compile
//     time) + the fused resize/normalize, with a multithreaded batch entry
//     point, so the loader's hot path holds no Python. Images the codecs
//     cannot handle (other formats, exotic JPEG color spaces) report a
//     per-image status, and the Python caller falls back to PIL for just
//     those.
//
// Sampling convention: half-pixel centers (align_corners=false), matching
// the numpy mirror `resize_normalize_reference` in
// sat_tpu_torch/data/native.py, which the tests compare against.

#include <algorithm>
#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

// SAT_NO_JPEG / SAT_NO_PNG / SAT_NO_CODECS are set by the fallback builds
// of sat_tpu_torch/data/native.py for hosts where a codec's headers exist
// but its shared library isn't linkable: each codec drops independently.
#if !defined(SAT_NO_CODECS) && !defined(SAT_NO_JPEG) && __has_include(<jpeglib.h>)
#define SAT_HAS_JPEG 1
#include <jpeglib.h>
#endif
#if !defined(SAT_NO_CODECS) && !defined(SAT_NO_PNG) && __has_include(<png.h>)
#define SAT_HAS_PNG 1
#include <png.h>
#endif

extern "C" {

// src: (sh, sw, 3) uint8 RGB, C-contiguous.
// dst: (dh, dw, 3) float32, C-contiguous, normalized (x/255 - mean) / std.
void resize_normalize(const uint8_t* src, int sh, int sw,
                      float* dst, int dh, int dw,
                      const float* mean, const float* stddev) {
    // Coordinates in double: keeps index/weight math exact for large
    // downscale factors (the per-pixel blend stays float32).
    const double scale_h = static_cast<double>(sh) / dh;
    const double scale_w = static_cast<double>(sw) / dw;
    const float inv255 = 1.0f / 255.0f;
    float inv_std[3] = {1.0f / stddev[0], 1.0f / stddev[1], 1.0f / stddev[2]};

    for (int oy = 0; oy < dh; ++oy) {
        double fy = (oy + 0.5) * scale_h - 0.5;
        fy = std::max(0.0, std::min(fy, static_cast<double>(sh - 1)));
        const int y0 = static_cast<int>(fy);
        const int y1 = std::min(y0 + 1, sh - 1);
        const float wy = static_cast<float>(fy - y0);

        float* out_row = dst + static_cast<int64_t>(oy) * dw * 3;
        const uint8_t* row0 = src + static_cast<int64_t>(y0) * sw * 3;
        const uint8_t* row1 = src + static_cast<int64_t>(y1) * sw * 3;

        for (int ox = 0; ox < dw; ++ox) {
            double fx = (ox + 0.5) * scale_w - 0.5;
            fx = std::max(0.0, std::min(fx, static_cast<double>(sw - 1)));
            const int x0 = static_cast<int>(fx);
            const int x1 = std::min(x0 + 1, sw - 1);
            const float wx = static_cast<float>(fx - x0);

            const float w00 = (1 - wy) * (1 - wx), w01 = (1 - wy) * wx;
            const float w10 = wy * (1 - wx), w11 = wy * wx;
            const uint8_t* p00 = row0 + x0 * 3;
            const uint8_t* p01 = row0 + x1 * 3;
            const uint8_t* p10 = row1 + x0 * 3;
            const uint8_t* p11 = row1 + x1 * 3;

            for (int c = 0; c < 3; ++c) {
                const float v = w00 * p00[c] + w01 * p01[c]
                              + w10 * p10[c] + w11 * p11[c];
                out_row[ox * 3 + c] = (v * inv255 - mean[c]) * inv_std[c];
            }
        }
    }
}

// Batch entry point: n images with per-image (sh, sw) dims packed in
// `dims`, sources via an offset table into one contiguous byte buffer.
void resize_normalize_batch(const uint8_t* src_buf, const int64_t* offsets,
                            const int* dims, int n,
                            float* dst, int dh, int dw,
                            const float* mean, const float* stddev) {
    const int64_t out_stride = static_cast<int64_t>(dh) * dw * 3;
    for (int i = 0; i < n; ++i) {
        resize_normalize(src_buf + offsets[i], dims[2 * i], dims[2 * i + 1],
                         dst + i * out_stride, dh, dw, mean, stddev);
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Tier 2: in-native decode.

// Per-image status codes (keep in sync with sat_tpu_torch/data/native.py).
enum {
    SAT_OK = 0,
    SAT_ERR_READ = 1,      // file missing / unreadable
    SAT_ERR_FORMAT = 2,    // not a JPEG/PNG magic, or codec not compiled in
    SAT_ERR_DECODE = 3,    // codec rejected the stream
};

#ifdef SAT_HAS_JPEG
struct SatJpegErr {
    jpeg_error_mgr pub;
    jmp_buf jb;
};

static void sat_jpeg_error_exit(j_common_ptr cinfo) {
    SatJpegErr* err = reinterpret_cast<SatJpegErr*>(cinfo->err);
    longjmp(err->jb, 1);
}

static void sat_jpeg_emit_message(j_common_ptr, int) {}  // silence warnings

// Decode a JPEG byte stream to tightly-packed RGB. Returns SAT_OK and a
// malloc'd buffer the caller frees, or an error code.
static int decode_jpeg(const uint8_t* data, size_t len,
                       uint8_t** out, int* w, int* h) {
    jpeg_decompress_struct cinfo;
    SatJpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = sat_jpeg_error_exit;
    jerr.pub.emit_message = sat_jpeg_emit_message;
    uint8_t* volatile buf = nullptr;   // volatile: survives longjmp
    if (setjmp(jerr.jb)) {
        free(buf);
        jpeg_destroy_decompress(&cinfo);
        return SAT_ERR_DECODE;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;   // grayscale/YCbCr -> RGB in-codec
    jpeg_start_decompress(&cinfo);
    const int width = static_cast<int>(cinfo.output_width);
    const int height = static_cast<int>(cinfo.output_height);
    if (cinfo.output_components != 3 || width <= 0 || height <= 0) {
        jpeg_destroy_decompress(&cinfo);
        return SAT_ERR_DECODE;
    }
    buf = static_cast<uint8_t*>(
        malloc(static_cast<size_t>(width) * height * 3));
    if (!buf) {
        jpeg_destroy_decompress(&cinfo);
        return SAT_ERR_DECODE;
    }
    const int64_t stride = static_cast<int64_t>(width) * 3;
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = buf + cinfo.output_scanline * stride;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    *out = buf;
    *w = width;
    *h = height;
    return SAT_OK;
}
#endif  // SAT_HAS_JPEG

#ifdef SAT_HAS_PNG
// Decode a PNG byte stream to tightly-packed RGB via libpng's simplified
// API (alpha composited away, gray expanded, 16-bit narrowed — PNG_FORMAT_RGB
// covers all of it).
static int decode_png(const uint8_t* data, size_t len,
                      uint8_t** out, int* w, int* h) {
    png_image image;
    memset(&image, 0, sizeof image);
    image.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_memory(&image, data, len))
        return SAT_ERR_DECODE;
    image.format = PNG_FORMAT_RGB;
    uint8_t* buf = static_cast<uint8_t*>(malloc(PNG_IMAGE_SIZE(image)));
    if (!buf) {
        png_image_free(&image);
        return SAT_ERR_DECODE;
    }
    if (!png_image_finish_read(&image, nullptr, buf, 0, nullptr)) {
        free(buf);
        png_image_free(&image);
        return SAT_ERR_DECODE;
    }
    *out = buf;
    *w = static_cast<int>(image.width);
    *h = static_cast<int>(image.height);
    return SAT_OK;
}
#endif  // SAT_HAS_PNG

static int decode_any(const uint8_t* data, size_t len,
                      uint8_t** out, int* w, int* h) {
    if (len >= 3 && data[0] == 0xFF && data[1] == 0xD8 && data[2] == 0xFF) {
#ifdef SAT_HAS_JPEG
        return decode_jpeg(data, len, out, w, h);
#else
        return SAT_ERR_FORMAT;
#endif
    }
    if (len >= 8 && memcmp(data, "\x89PNG\r\n\x1a\n", 8) == 0) {
#ifdef SAT_HAS_PNG
        return decode_png(data, len, out, w, h);
#else
        return SAT_ERR_FORMAT;
#endif
    }
    return SAT_ERR_FORMAT;
}

extern "C" {

// Bitmask of compiled-in codecs: 1 = JPEG, 2 = PNG.
int decode_support() {
    int mask = 0;
#ifdef SAT_HAS_JPEG
    mask |= 1;
#endif
#ifdef SAT_HAS_PNG
    mask |= 2;
#endif
    return mask;
}

// Full single-image path: read file -> decode -> fused resize+normalize
// into dst (dh, dw, 3) float32. Returns a SAT_* status.
int load_resize_normalize(const char* path, float* dst, int dh, int dw,
                          const float* mean, const float* stddev) {
    FILE* f = fopen(path, "rb");
    if (!f) return SAT_ERR_READ;
    fseek(f, 0, SEEK_END);
    const long fsize = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (fsize <= 0) {
        fclose(f);
        return SAT_ERR_READ;
    }
    std::vector<uint8_t> data(static_cast<size_t>(fsize));
    const size_t got = fread(data.data(), 1, data.size(), f);
    fclose(f);
    if (got != data.size()) return SAT_ERR_READ;

    uint8_t* rgb = nullptr;
    int w = 0, h = 0;
    const int st = decode_any(data.data(), data.size(), &rgb, &w, &h);
    if (st != SAT_OK) return st;
    resize_normalize(rgb, h, w, dst, dh, dw, mean, stddev);
    free(rgb);
    return SAT_OK;
}

// Batch of files across a worker pool (ctypes releases the GIL for the
// whole call, so the pool gets real cores on production hosts). dst is
// (n, dh, dw, 3) float32; status is one SAT_* per image — callers fall
// back to the Python loader for any non-zero row.
void load_resize_normalize_batch(const char** paths, int n,
                                 float* dst, int dh, int dw,
                                 const float* mean, const float* stddev,
                                 int n_threads, int32_t* status) {
    const int64_t out_stride = static_cast<int64_t>(dh) * dw * 3;
    std::atomic<int> next(0);
    auto worker = [&]() {
        for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
            status[i] = load_resize_normalize(
                paths[i], dst + i * out_stride, dh, dw, mean, stddev);
        }
    };
    const int nt = std::max(1, std::min(n_threads, n));
    if (nt == 1) {
        worker();
        return;
    }
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
}

}  // extern "C"
