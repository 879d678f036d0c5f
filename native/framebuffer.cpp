// Host-side framebuffer codec: float RGB -> sRGB u8 -> BMP bytes.
//
// Equivalent of the reference's native (D) host runtime around
// the renderer: the per-frame Color->uint conversion through the cached
// sRGB LUT (reference source/rt/color.d:194-228) and the 24-bpp
// bottom-up BMP writer (reference imageio/bmp.d:195-237).  This is the
// host hot path when streaming frames off the device; the Python/numpy
// implementation (chess2rt_tpu/utils/color.py, imageio/bmp.py) remains the
// reference oracle and fallback.
//
// Build: g++ -O3 -shared -fPIC framebuffer.cpp -o libc2rt_native.so
// ABI: plain C, consumed via ctypes (chess2rt_tpu/native.py).

#include <cstdint>
#include <cstring>
#include <cmath>

namespace {

// 4097-entry sRGB compression cache, built exactly like the reference
// module constructor (color.d:221-228): quantize x to i = int(x*4096),
// LUT[i] = convertTo8bit_sRGB(i/4096f) with the 12.02 linear-segment
// constant quirk (color.d:201) and floor(x*255) byte rounding.
struct SrgbLut {
    uint8_t lut[4097];
    SrgbLut() {
        for (int i = 0; i <= 4096; ++i) {
            float x = (float)i / 4096.0f;
            float y;
            if (x <= 0.0f) { lut[i] = 0; continue; }
            if (x >= 1.0f) { lut[i] = 255; continue; }
            if (x <= 0.0031308f)
                y = x * 12.02f;
            else
                y = (float)(1.055 * std::pow((double)x, 1.0 / 2.4) - 0.055);
            int b = (int)std::floor(y * 255.0f);
            lut[i] = (uint8_t)(b < 0 ? 0 : (b > 255 ? 255 : b));
        }
    }
};
const SrgbLut g_srgb;

inline uint8_t srgb_u8(float x) {
    // NaN fails both comparisons below; without a clamp the computed LUT
    // index would be undefined (the numpy path clips to [0, 4096]).
    if (!(x > 0.0f)) return 0;   // x <= 0 or NaN
    if (x >= 1.0f) return 255;
    int i = (int)(x * 4096.0f);
    if (i < 0) i = 0;
    if (i > 4096) i = 4096;
    return g_srgb.lut[i];
}

void put_u16(uint8_t* p, uint16_t v) { std::memcpy(p, &v, 2); }
void put_u32(uint8_t* p, uint32_t v) { std::memcpy(p, &v, 4); }

}  // namespace

extern "C" {

// rgb: n*3 floats in [0,1]; out: n*3 bytes (same channel order).
void c2rt_srgb_quantize(const float* rgb, uint8_t* out, int64_t n) {
    for (int64_t i = 0; i < n * 3; ++i) out[i] = srgb_u8(rgb[i]);
}

// Required output capacity for c2rt_bmp_encode.
int64_t c2rt_bmp_size(int32_t w, int32_t h, int32_t pad_rows) {
    int64_t row = (int64_t)w * 3;
    if (pad_rows) row = (row + 3) & ~3ll;
    return 54 + row * h;
}

// rgb: h*w*3 floats, row 0 = top.  Writes a 24-bpp BITMAPINFOHEADER BMP
// with bottom-up rows.  pad_rows=0 reproduces the reference writer's
// no-row-padding quirk (imageio/bmp.d:195-237); pad_rows=1 is
// spec-compliant 4-byte padding.  Returns bytes written.
int64_t c2rt_bmp_encode(const float* rgb, int32_t w, int32_t h,
                        int32_t pad_rows, uint8_t* out) {
    int64_t row_bytes = (int64_t)w * 3;
    int64_t stride = pad_rows ? ((row_bytes + 3) & ~3ll) : row_bytes;
    int64_t total = 54 + stride * h;

    std::memset(out, 0, 54);
    out[0] = 'B'; out[1] = 'M';
    put_u32(out + 2, (uint32_t)total);
    put_u32(out + 10, 54);            // pixel array offset
    put_u32(out + 14, 40);            // BITMAPINFOHEADER
    put_u32(out + 18, (uint32_t)w);
    put_u32(out + 22, (uint32_t)h);   // positive: bottom-up
    put_u16(out + 26, 1);             // planes
    put_u16(out + 28, 24);            // bpp
    put_u32(out + 34, (uint32_t)(stride * h));
    put_u32(out + 38, 2835);          // 72 DPI
    put_u32(out + 42, 2835);

    for (int32_t y = 0; y < h; ++y) {
        const float* src = rgb + (int64_t)(h - 1 - y) * w * 3;  // bottom-up
        uint8_t* dst = out + 54 + (int64_t)y * stride;
        for (int32_t x = 0; x < w; ++x) {
            // BGR byte order (Color::toRGB32 default shifts, color.d:154-162)
            dst[x * 3 + 0] = srgb_u8(src[x * 3 + 2]);
            dst[x * 3 + 1] = srgb_u8(src[x * 3 + 1]);
            dst[x * 3 + 2] = srgb_u8(src[x * 3 + 0]);
        }
        if (stride > row_bytes) std::memset(dst + row_bytes, 0, stride - row_bytes);
    }
    return total;
}

}  // extern "C"
