// fastdata: the host-side background decode of the PyTorch port's data
// loader (layoutdetr_tpu_torch/data/native.py binds it with ctypes).
//
// The loader's per-sample host work is zip-stored PNG decode -> Lanczos
// resize -> ImageNet normalise. The reference does it in Python/PIL inside
// torch DataLoader workers (training/dataset_layoutganpp.py:267-342); this
// library does it in C++: zlib inflate, PNG unfilter and PIL's separable
// Lanczos-3 in its fixed point, so its output is PIL's bit for bit. It began
// as the JAX package's native/fastdata.cpp: the decode and the normalise
// give that file's bytes, the resize PIL's where that file's (double
// sums, rounded) is a level off on up to a few percent of the pixels of a
// smooth page.
//
// Build (data/native.py does this at first use, into build/):
//   g++ -O3 -shared -fPIC -o libfastdata.so fastdata.cpp -lz
//
// Supported PNG subset: 8-bit gray / gray+alpha / RGB / RGBA,
// non-interlaced (what dataset_tool.py writes: RGB).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <vector>
#include <zlib.h>

namespace {

inline uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

}  // namespace

extern "C" {

// Decode a PNG byte buffer into tightly-packed RGB8 [h, w, 3].
// Returns 0 on success; fills *out_w/*out_h. `out` must hold
// max_w*max_h*3 bytes. Negative return = error code.
int fd_decode_png(const uint8_t* buf, int64_t len, uint8_t* out,
                  int64_t max_bytes, int* out_w, int* out_h) {
    static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    if (len < 8 || std::memcmp(buf, magic, 8) != 0) return -1;

    int64_t pos = 8;
    uint32_t w = 0, h = 0;
    int bit_depth = 0, color_type = 0, interlace = 0;
    std::vector<uint8_t> idat;

    while (pos + 8 <= len) {
        uint32_t chunk_len = be32(buf + pos);
        const uint8_t* type = buf + pos + 4;
        const uint8_t* data = buf + pos + 8;
        if (pos + 12 + chunk_len > (uint64_t)len) return -2;
        if (!std::memcmp(type, "IHDR", 4)) {
            w = be32(data);
            h = be32(data + 4);
            bit_depth = data[8];
            color_type = data[9];
            interlace = data[12];
        } else if (!std::memcmp(type, "IDAT", 4)) {
            idat.insert(idat.end(), data, data + chunk_len);
        } else if (!std::memcmp(type, "IEND", 4)) {
            break;
        }
        pos += 12 + chunk_len;
    }
    if (w == 0 || h == 0 || bit_depth != 8 || interlace != 0) return -3;

    int channels;
    switch (color_type) {
        case 0: channels = 1; break;  // gray
        case 2: channels = 3; break;  // rgb
        case 4: channels = 2; break;  // gray+alpha
        case 6: channels = 4; break;  // rgba
        default: return -4;           // palette unsupported
    }
    if ((int64_t)w * h * 3 > max_bytes) return -5;

    const int64_t stride = (int64_t)w * channels;
    std::vector<uint8_t> raw((stride + 1) * h);
    uLongf raw_len = raw.size();
    if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK)
        return -6;

    std::vector<uint8_t> prev(stride, 0);
    std::vector<uint8_t> cur(stride);
    for (uint32_t y = 0; y < h; ++y) {
        const uint8_t* row = raw.data() + (stride + 1) * y;
        int filter = row[0];
        const uint8_t* src = row + 1;
        for (int64_t x = 0; x < stride; ++x) {
            int a = (x >= channels) ? cur[x - channels] : 0;
            int b = prev[x];
            int c = (x >= channels) ? prev[x - channels] : 0;
            int v = src[x];
            switch (filter) {
                case 0: break;
                case 1: v += a; break;
                case 2: v += b; break;
                case 3: v += (a + b) / 2; break;
                case 4: v += paeth(a, b, c); break;
                default: return -7;
            }
            cur[x] = (uint8_t)v;
        }
        uint8_t* dst = out + (int64_t)y * w * 3;
        for (uint32_t x = 0; x < w; ++x) {
            const uint8_t* px = cur.data() + (int64_t)x * channels;
            switch (channels) {
                case 1: dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = px[0]; break;
                case 2: dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = px[0]; break;
                case 3: std::memcpy(dst + 3 * x, px, 3); break;
                case 4: std::memcpy(dst + 3 * x, px, 3); break;
            }
        }
        std::swap(prev, cur);
    }
    *out_w = (int)w;
    *out_h = (int)h;
    return 0;
}

namespace {

// PIL's Lanczos-3 (libImaging/Resample.c): sinc(x) * sinc(x / 3) on [-3, 3).
double sinc(double x) {
    if (x == 0.0) return 1.0;
    x = x * M_PI;
    return std::sin(x) / x;
}

double lanczos(double x) {
    if (-3.0 <= x && x < 3.0) return sinc(x) * sinc(x / 3.0);
    return 0.0;
}

// PIL's 8bpc fixed point: coefficients scaled by 2^22, a half added before
// the shift, the sum clipped to [0, 255].
const int kPrecisionBits = 32 - 8 - 2;

inline uint8_t clip8(int32_t in) {
    if (in >= (1 << kPrecisionBits << 8)) return 255;
    if (in <= 0) return 0;
    return (uint8_t)(in >> kPrecisionBits);
}

// The contribution table for one axis (PIL's precompute_coeffs and
// normalize_coeffs_8bpc, box = the whole axis).
struct Taps {
    std::vector<int> start;
    std::vector<int> size;
    std::vector<int32_t> weights;  // [out, max_size]
    int max_size;
};

Taps build_taps(int in_size, int out_size) {
    Taps t;
    double scale = (double)in_size / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = 3.0 * filterscale;
    double ss = 1.0 / filterscale;
    t.max_size = (int)std::ceil(support) * 2 + 1;
    t.start.resize(out_size);
    t.size.resize(out_size);
    t.weights.assign((size_t)out_size * t.max_size, 0);
    std::vector<double> k(t.max_size);
    for (int xx = 0; xx < out_size; ++xx) {
        double center = (xx + 0.5) * scale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        int n = xmax - xmin;
        double ww = 0.0;
        for (int x = 0; x < n; ++x) {
            k[x] = lanczos((x + xmin - center + 0.5) * ss);
            ww += k[x];
        }
        for (int x = 0; x < n; ++x) {
            double w = ww != 0.0 ? k[x] / ww : k[x];
            t.weights[(size_t)xx * t.max_size + x] =
                w < 0 ? (int32_t)(-0.5 + w * (1 << kPrecisionBits))
                      : (int32_t)(0.5 + w * (1 << kPrecisionBits));
        }
        t.start[xx] = xmin;
        t.size[xx] = n;
    }
    return t;
}

}  // namespace

// Separable Lanczos-3 resize, RGB8 in -> RGB8 out: PIL's LANCZOS bit for
// bit (its 8bpc pipeline: horizontal pass to a uint8 intermediate, then
// vertical, each pass in 2^22 fixed point, rounded and clipped).
int fd_resize_lanczos(const uint8_t* src, int sw, int sh,
                      uint8_t* dst, int dw, int dh) {
    Taps tx = build_taps(sw, dw);
    Taps ty = build_taps(sh, dh);
    const int32_t half = 1 << (kPrecisionBits - 1);

    std::vector<uint8_t> tmp((size_t)sh * dw * 3);
    for (int y = 0; y < sh; ++y) {
        const uint8_t* row = src + (size_t)y * sw * 3;
        for (int x = 0; x < dw; ++x) {
            const int32_t* wp = &tx.weights[(size_t)x * tx.max_size];
            int32_t acc[3] = {half, half, half};
            for (int k = 0; k < tx.size[x]; ++k) {
                const uint8_t* px = row + (size_t)(tx.start[x] + k) * 3;
                acc[0] += px[0] * wp[k];
                acc[1] += px[1] * wp[k];
                acc[2] += px[2] * wp[k];
            }
            uint8_t* o = &tmp[((size_t)y * dw + x) * 3];
            for (int c = 0; c < 3; ++c) o[c] = clip8(acc[c]);
        }
    }
    for (int y = 0; y < dh; ++y) {
        const int32_t* wp = &ty.weights[(size_t)y * ty.max_size];
        for (int x = 0; x < dw; ++x) {
            int32_t acc[3] = {half, half, half};
            for (int k = 0; k < ty.size[y]; ++k) {
                const uint8_t* px = &tmp[(((size_t)(ty.start[y] + k)) * dw + x) * 3];
                acc[0] += px[0] * wp[k];
                acc[1] += px[1] * wp[k];
                acc[2] += px[2] * wp[k];
            }
            uint8_t* o = dst + ((size_t)y * dw + x) * 3;
            for (int c = 0; c < 3; ++c) o[c] = clip8(acc[c]);
        }
    }
    return 0;
}

// RGB8 [h, w, 3] -> ImageNet-normalized float32 NHWC.
void fd_normalize(const uint8_t* src, float* dst, int64_t n_pixels) {
    static const float mean[3] = {0.485f, 0.456f, 0.406f};
    static const float stdv[3] = {0.229f, 0.224f, 0.225f};
    for (int64_t i = 0; i < n_pixels; ++i) {
        for (int c = 0; c < 3; ++c) {
            dst[3 * i + c] = (src[3 * i + c] / 255.0f - mean[c]) / stdv[c];
        }
    }
}

// Fused: decode -> resize -> normalize. Returns 0 on success.
int fd_load_background(const uint8_t* png, int64_t png_len, int out_size,
                       float* dst, uint8_t* scratch, int64_t scratch_bytes) {
    int w = 0, h = 0;
    int rc = fd_decode_png(png, png_len, scratch, scratch_bytes, &w, &h);
    if (rc != 0) return rc;
    std::vector<uint8_t> resized((size_t)out_size * out_size * 3);
    fd_resize_lanczos(scratch, w, h, resized.data(), out_size, out_size);
    fd_normalize(resized.data(), dst, (int64_t)out_size * out_size);
    return 0;
}

}  // extern "C"
