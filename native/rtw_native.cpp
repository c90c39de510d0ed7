#include <cstdio>
// rtw native runtime components (C++17, no dependencies).
//
// The reference's native host tier is Director.cpp + stb_image: scene
// upload, output-buffer management and the PPM sink (printPPM,
// RestOfLife/Director.cpp:1010-1031).  The device compute path of this
// framework is JAX/Pallas; the host-side byte-bashing that the reference
// does in C++ stays in C++ here: P3-PPM encoding of the final frame
// (the pure-Python encoder needs ~10 s for a 3840x2240 frame, this runs
// in ~60 ms) and RGB8->uint32 texture-atlas packing.
//
// Exposed as a plain C ABI consumed via ctypes (rtw/utils/native.py);
// everything has a NumPy fallback so the framework works without a
// compiler.

#include <cstdint>
#include <cstddef>
#include <cstring>

extern "C" {

// Encode a top-row-first uint8 [h, w, 3] image as P3 PPM text into `out`.
// Returns the number of bytes written.  `out` must have room for
// 16 + 32 + n_pixels*12 bytes (worst case "255 255 255\n").
size_t rtw_ppm_encode(const uint8_t* img, int64_t h, int64_t w, char* out) {
    char* p = out;
    // header
    p += std::sprintf(p, "P3\n%lld %lld\n255\n",
                      static_cast<long long>(w), static_cast<long long>(h));
    const int64_t n = h * w;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* px = img + i * 3;
        // unrolled fast uint8 -> decimal
        for (int c = 0; c < 3; ++c) {
            unsigned v = px[c];
            if (v >= 100) {
                *p++ = '0' + v / 100;
                v %= 100;
                *p++ = '0' + v / 10;
                *p++ = '0' + v % 10;
            } else if (v >= 10) {
                *p++ = '0' + v / 10;
                *p++ = '0' + v % 10;
            } else {
                *p++ = '0' + v;
            }
            *p++ = (c == 2) ? '\n' : ' ';
        }
    }
    return static_cast<size_t>(p - out);
}

// Pack uint8 [n, 3] RGB rows into 0x00BBGGRR uint32 texels
// (Textures.images_packed layout).
void rtw_pack_rgb8(const uint8_t* img, int64_t n, uint32_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* px = img + i * 3;
        out[i] = static_cast<uint32_t>(px[0])
               | (static_cast<uint32_t>(px[1]) << 8)
               | (static_cast<uint32_t>(px[2]) << 16);
    }
}

// Clamp [0,1] + gamma-encode + quantize a float32 [n] plane to uint8
// (to_srgb8's hot loop; gamma 2.0 -> inv_gamma 0.5).
void rtw_srgb_encode(const float* linear, int64_t n, float inv_gamma,
                     uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        float v = linear[i];
        v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
        v = __builtin_powf(v, inv_gamma) * 255.99f;
        out[i] = static_cast<uint8_t>(v);
    }
}

// Bit-exact reference host RNG stream (lib/random.cuh:22-38): fills `out`
// with `n` consecutive randf() draws from the xorshift32 state `seed`.
// Returns the advanced state (scene builders draw tens of thousands of
// these for the random scenes).
uint32_t rtw_xorshift32_fill(uint32_t seed, int64_t n, float* out) {
    uint32_t s = seed;
    for (int64_t i = 0; i < n; ++i) {
        s ^= s << 13;
        s ^= s >> 17;
        s ^= s << 5;
        float r = static_cast<float>(s) / 4294967296.0f;
        out[i] = (r != 1.0f) ? r : static_cast<float>(0x3F7FFFFF);
    }
    return s;
}

}  // extern "C"
