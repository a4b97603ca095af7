// Native image core: Pillow-compatible bicubic resample + fused normalize.
//
// The port's copy of the JAX package's native/imagecore.cpp, with the same
// C interface.  This core reimplements the exact
// fixed-point separable resample Pillow uses for 8-bit images (two passes
// through a uint8 intermediate, 22-bit coefficients, the same coefficient
// rounding), so outputs are BIT-IDENTICAL to PIL.Image.resize(..., BICUBIC)
// — which is what HF's ViltImageProcessor runs, keeping the pixel-parity
// contract (reference call site vault/models/vault/processor.py:12) — and
// fuses the (x/255 - mean)/std normalize + HWC->CHW transpose into the
// vertical pass output loop.
//
// Built with the host C++ compiler at first use by
// vault_tpu_torch/ops/_build_host.py.
//
// Exported C ABI (ctypes, vault_tpu_torch/data/native_image.py):
//   ic_resize_rgb8:       uint8 HWC -> uint8 HWC resize (parity testing)
//   ic_resize_normalize:  uint8 HWC -> float32 CHW resized+normalized
//   ic_normalize_chw:     uint8 HWC -> float32 CHW (no resize)

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int PRECISION_BITS = 32 - 8 - 2;  // Pillow Resample.c

inline double bicubic_filter(double x) {
    // Pillow's bicubic kernel, a = -0.5, support 2.0
    constexpr double a = -0.5;
    if (x < 0.0) x = -x;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
    if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
    return 0.0;
}

constexpr double SUPPORT = 2.0;

inline uint8_t clip8(int in) {
    if (in >= (1 << PRECISION_BITS << 8)) return 255;
    if (in <= 0) return 0;
    return (uint8_t)(in >> PRECISION_BITS);
}

// Pillow precompute_coeffs (full box): double coefficients then the same
// round-half-away int conversion normalize_coeffs_8bpc performs.
int precompute_coeffs(int in_size, int out_size, std::vector<int>& bounds,
                      std::vector<int32_t>& kk) {
    double scale = (double)in_size / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = SUPPORT * filterscale;
    int ksize = (int)ceil(support) * 2 + 1;
    std::vector<double> prekk((size_t)out_size * ksize, 0.0);
    bounds.resize((size_t)out_size * 2);
    for (int xx = 0; xx < out_size; xx++) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        double* k = &prekk[(size_t)xx * ksize];
        for (int x = 0; x < xmax; x++) {
            double w = bicubic_filter((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        if (ww != 0.0)
            for (int x = 0; x < xmax; x++) k[x] /= ww;
        bounds[xx * 2 + 0] = xmin;
        bounds[xx * 2 + 1] = xmax;
    }
    kk.resize(prekk.size());
    for (size_t i = 0; i < prekk.size(); i++) {
        kk[i] = prekk[i] < 0 ? (int32_t)(-0.5 + prekk[i] * (1 << PRECISION_BITS))
                             : (int32_t)(0.5 + prekk[i] * (1 << PRECISION_BITS));
    }
    return ksize;
}

// Horizontal pass: (rows, in_w, 3) u8 -> (rows, out_w, 3) u8
void resample_horizontal(const uint8_t* src, int rows, int in_w, uint8_t* dst,
                         int out_w, const std::vector<int>& bounds,
                         const std::vector<int32_t>& kk, int ksize) {
    for (int yy = 0; yy < rows; yy++) {
        const uint8_t* row = src + (size_t)yy * in_w * 3;
        uint8_t* orow = dst + (size_t)yy * out_w * 3;
        for (int xx = 0; xx < out_w; xx++) {
            int xmin = bounds[xx * 2], xmax = bounds[xx * 2 + 1];
            const int32_t* k = &kk[(size_t)xx * ksize];
            int ss0 = 1 << (PRECISION_BITS - 1);
            int ss1 = ss0, ss2 = ss0;
            const uint8_t* p = row + (size_t)xmin * 3;
            for (int x = 0; x < xmax; x++) {
                ss0 += p[x * 3 + 0] * k[x];
                ss1 += p[x * 3 + 1] * k[x];
                ss2 += p[x * 3 + 2] * k[x];
            }
            orow[xx * 3 + 0] = clip8(ss0);
            orow[xx * 3 + 1] = clip8(ss1);
            orow[xx * 3 + 2] = clip8(ss2);
        }
    }
}

// Vertical pass: (in_h, cols, 3) u8 -> (out_h, cols, 3) u8.
// Row-major accumulation: for each output row, add whole contributing input
// rows into an int32 accumulator line — contiguous loads the compiler
// auto-vectorizes (the naive per-column inner loop measured ~2x slower).
void resample_vertical(const uint8_t* src, int in_h, int cols, uint8_t* dst,
                       int out_h, const std::vector<int>& bounds,
                       const std::vector<int32_t>& kk, int ksize) {
    const int n = cols * 3;
    std::vector<int32_t> acc(n);
    for (int yy = 0; yy < out_h; yy++) {
        int ymin = bounds[yy * 2], ymax = bounds[yy * 2 + 1];
        const int32_t* k = &kk[(size_t)yy * ksize];
        int32_t* a = acc.data();
        for (int i = 0; i < n; i++) a[i] = 1 << (PRECISION_BITS - 1);
        for (int y = 0; y < ymax; y++) {
            const uint8_t* row = src + (size_t)(y + ymin) * n;
            const int32_t ky = k[y];
            for (int i = 0; i < n; i++) a[i] += row[i] * ky;
        }
        uint8_t* orow = dst + (size_t)yy * n;
        for (int i = 0; i < n; i++) orow[i] = clip8(a[i]);
    }
}

// Full Pillow-order resample (horizontal then vertical, u8 intermediate).
void resample(const uint8_t* src, int h, int w, uint8_t* dst, int oh, int ow) {
    std::vector<int> hb, vb;
    std::vector<int32_t> hk, vk;
    if (ow != w && oh != h) {
        int hks = precompute_coeffs(w, ow, hb, hk);
        int vks = precompute_coeffs(h, oh, vb, vk);
        std::vector<uint8_t> tmp((size_t)h * ow * 3);
        resample_horizontal(src, h, w, tmp.data(), ow, hb, hk, hks);
        resample_vertical(tmp.data(), h, ow, dst, oh, vb, vk, vks);
    } else if (ow != w) {
        int hks = precompute_coeffs(w, ow, hb, hk);
        resample_horizontal(src, h, w, dst, ow, hb, hk, hks);
    } else if (oh != h) {
        int vks = precompute_coeffs(h, oh, vb, vk);
        resample_vertical(src, h, w, dst, oh, vb, vk, vks);
    } else {
        memcpy(dst, src, (size_t)h * w * 3);
    }
}

}  // namespace

extern "C" {

// uint8 (h, w, 3) -> uint8 (oh, ow, 3); bit-identical to
// PIL.Image.resize((ow, oh), Image.BICUBIC) on RGB input.
void ic_resize_rgb8(const uint8_t* src, int h, int w, uint8_t* dst, int oh,
                    int ow) {
    resample(src, h, w, dst, oh, ow);
}

// uint8 (h, w, 3) -> float32 (3, dst_h, dst_w) top-left region written with
// (x/255 - mean)/std; the rest of dst is left untouched (caller zeroes the
// canvas).  No resize.
void ic_normalize_chw(const uint8_t* src, int h, int w, float* dst, int dst_h,
                      int dst_w, float mean, float std) {
    float lut[256];
    for (int i = 0; i < 256; i++) lut[i] = ((float)i / 255.0f - mean) / std;
    for (int c = 0; c < 3; c++) {
        float* plane = dst + (size_t)c * dst_h * dst_w;
        for (int y = 0; y < h; y++) {
            const uint8_t* row = src + (size_t)y * w * 3 + c;
            float* orow = plane + (size_t)y * dst_w;
            for (int x = 0; x < w; x++) orow[x] = lut[row[x * 3]];
        }
    }
}

// Fused resize (uint8, Pillow-exact) + normalize into a float32 CHW canvas.
void ic_resize_normalize(const uint8_t* src, int h, int w, int oh, int ow,
                         float* dst, int dst_h, int dst_w, float mean,
                         float std) {
    std::vector<uint8_t> resized((size_t)oh * ow * 3);
    resample(src, h, w, resized.data(), oh, ow);
    ic_normalize_chw(resized.data(), oh, ow, dst, dst_h, dst_w, mean, std);
}

}  // extern "C"
