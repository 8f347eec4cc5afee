// Native image-decode helpers: PNG scanline unfiltering.
//
// The reference renders PNG via vendored lodepng (pbrt's src/ext/
// lodepng.cpp, used by imageio.cpp:46-60); here the container parsing stays
// in Python (bre_tpu_torch/io/image.py) and only the strictly sequential
// per-byte filter reconstruction (PNG spec 4.5.4: None/Sub/Up/Average/Paeth)
// runs natively.
//
// Built by bre_tpu_torch/native/__init__.py: g++ -O2 -shared -fPIC.

#include <cstdint>
#include <cstdlib>
#include <cmath>

extern "C" {

// raw: h * (1 + stride) filtered bytes (leading filter-type byte per row).
// out: h * stride reconstructed bytes. fbpp: filter unit (bytes per pixel).
// Returns 0 on success, -1 on a bad filter type.
int64_t png_unfilter(const uint8_t* raw, int64_t h, int64_t stride,
                     int64_t fbpp, uint8_t* out) {
    const uint8_t* prev = nullptr;
    for (int64_t y = 0; y < h; ++y) {
        uint8_t ft = raw[y * (stride + 1)];
        const uint8_t* line = raw + y * (stride + 1) + 1;
        uint8_t* cur = out + y * stride;
        switch (ft) {
        case 0:
            for (int64_t i = 0; i < stride; ++i) cur[i] = line[i];
            break;
        case 1:  // Sub
            for (int64_t i = 0; i < fbpp; ++i) cur[i] = line[i];
            for (int64_t i = fbpp; i < stride; ++i)
                cur[i] = uint8_t(line[i] + cur[i - fbpp]);
            break;
        case 2:  // Up
            if (prev)
                for (int64_t i = 0; i < stride; ++i)
                    cur[i] = uint8_t(line[i] + prev[i]);
            else
                for (int64_t i = 0; i < stride; ++i) cur[i] = line[i];
            break;
        case 3:  // Average
            for (int64_t i = 0; i < stride; ++i) {
                int a = i >= fbpp ? cur[i - fbpp] : 0;
                int b = prev ? prev[i] : 0;
                cur[i] = uint8_t(line[i] + ((a + b) >> 1));
            }
            break;
        case 4:  // Paeth
            for (int64_t i = 0; i < stride; ++i) {
                int a = i >= fbpp ? cur[i - fbpp] : 0;
                int b = prev ? prev[i] : 0;
                int c = (prev && i >= fbpp) ? prev[i - fbpp] : 0;
                int p = a + b - c;
                int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
                int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                cur[i] = uint8_t(line[i] + pred);
            }
            break;
        default:
            return -1;
        }
        prev = cur;
    }
    return 0;
}

}  // extern "C"
