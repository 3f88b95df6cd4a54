// Native frame codec: point-sprite rasterization + binary PLY export.
//
// The headless equivalent of the reference's render path back end
// (Graphics.DrawMeshInstancedIndirect + InstancedIndirectColor.shader:
// transparent unlit instanced draw, ZWrite off): frames are exported
// host-side, and at multi-million particle counts the Python/numpy splatter
// becomes the bottleneck — this C++ path rasterizes depth-sorted colored
// discs (painter's algorithm, matching the shader's unsorted alpha blend
// visually) at memory speed. Loaded via ctypes; render/export.py falls back
// to the numpy implementation when the shared object is unavailable.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Rasterize n particles (screen xy, camera depth z, rgb8 colors) into an
// RGB8 image [h, w, 3], far-to-near. r_px holds per-particle pixel radii.
// Returns the number of particles drawn.
int64_t splat_points(const float* xy, const float* z, const float* r_px,
                     const uint8_t* rgb, int64_t n, uint8_t* img,
                     int64_t width, int64_t height) {
    std::vector<int64_t> order(n);
    std::iota(order.begin(), order.end(), 0);
    std::sort(order.begin(), order.end(),
              [z](int64_t a, int64_t b) { return z[a] > z[b]; });

    int64_t drawn = 0;
    for (int64_t k = 0; k < n; ++k) {
        const int64_t i = order[k];
        if (z[i] <= 0.05f) continue;
        const int64_t cx = llroundf(xy[2 * i]);
        const int64_t cy = llroundf(xy[2 * i + 1]);
        const int64_t r = std::clamp<int64_t>(llroundf(r_px[i]), 1, 64);
        if (cx + r < 0 || cx - r >= width || cy + r < 0 || cy - r >= height)
            continue;
        const uint8_t c0 = rgb[3 * i], c1 = rgb[3 * i + 1],
                      c2 = rgb[3 * i + 2];
        const int64_t r2 = r * r;
        const int64_t y0 = std::max<int64_t>(cy - r + 1, 0);
        const int64_t y1 = std::min<int64_t>(cy + r - 1, height - 1);
        for (int64_t y = y0; y <= y1; ++y) {
            const int64_t dy = y - cy;
            const int64_t half =
                (int64_t)std::sqrt((double)(r2 - dy * dy));
            const int64_t x0 = std::max<int64_t>(cx - half, 0);
            const int64_t x1 = std::min<int64_t>(cx + half, width - 1);
            uint8_t* row = img + 3 * (y * width + x0);
            for (int64_t x = x0; x <= x1; ++x) {
                row[0] = c0;
                row[1] = c1;
                row[2] = c2;
                row += 3;
            }
        }
        ++drawn;
    }
    return drawn;
}

// Translucent variant: SrcAlpha/OneMinusSrcAlpha compositing
// (InstancedIndirectColor.shader:6 "Blend SrcAlpha OneMinusSrcAlpha",
// ZWrite off :7), far-to-near painter order. Each particle composites
// SEQUENTIALLY, so overlapping discs blend in exact depth order — the
// behavioral spec the vectorized numpy fallback approximates. alpha is
// f32[n] in [0, 1]. Returns the number of particles drawn.
int64_t splat_points_alpha(const float* xy, const float* z, const float* r_px,
                           const uint8_t* rgb, const float* alpha, int64_t n,
                           uint8_t* img, int64_t width, int64_t height) {
    std::vector<int64_t> order(n);
    std::iota(order.begin(), order.end(), 0);
    std::sort(order.begin(), order.end(),
              [z](int64_t a, int64_t b) { return z[a] > z[b]; });

    int64_t drawn = 0;
    for (int64_t k = 0; k < n; ++k) {
        const int64_t i = order[k];
        if (z[i] <= 0.05f) continue;
        const int64_t cx = llroundf(xy[2 * i]);
        const int64_t cy = llroundf(xy[2 * i + 1]);
        const int64_t r = std::clamp<int64_t>(llroundf(r_px[i]), 1, 64);
        if (cx + r < 0 || cx - r >= width || cy + r < 0 || cy - r >= height)
            continue;
        const float a = std::clamp(alpha[i], 0.0f, 1.0f);
        const float c0 = a * rgb[3 * i], c1 = a * rgb[3 * i + 1],
                    c2 = a * rgb[3 * i + 2];
        const float ia = 1.0f - a;
        const int64_t r2 = r * r;
        const int64_t y0 = std::max<int64_t>(cy - r + 1, 0);
        const int64_t y1 = std::min<int64_t>(cy + r - 1, height - 1);
        for (int64_t y = y0; y <= y1; ++y) {
            const int64_t dy = y - cy;
            const int64_t half =
                (int64_t)std::sqrt((double)(r2 - dy * dy));
            const int64_t x0 = std::max<int64_t>(cx - half, 0);
            const int64_t x1 = std::min<int64_t>(cx + half, width - 1);
            uint8_t* row = img + 3 * (y * width + x0);
            for (int64_t x = x0; x <= x1; ++x) {
                row[0] = (uint8_t)(c0 + ia * row[0]);
                row[1] = (uint8_t)(c1 + ia * row[1]);
                row[2] = (uint8_t)(c2 + ia * row[2]);
                row += 3;
            }
        }
        ++drawn;
    }
    return drawn;
}

// Binary little-endian PLY point cloud (positions f32[n,3], colors u8[n,3],
// colors may be null). Returns 0 on success.
int32_t write_ply_binary(const char* path, const float* pos,
                         const uint8_t* rgb, int64_t n) {
    FILE* f = fopen(path, "wb");
    if (!f) return 1;
    fprintf(f,
            "ply\nformat binary_little_endian 1.0\nelement vertex %lld\n"
            "property float x\nproperty float y\nproperty float z\n",
            (long long)n);
    if (rgb)
        fprintf(f,
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\n");
    fprintf(f, "end_header\n");
    for (int64_t i = 0; i < n; ++i) {
        fwrite(pos + 3 * i, sizeof(float), 3, f);
        if (rgb) fwrite(rgb + 3 * i, 1, 3, f);
    }
    const int32_t rc = ferror(f) ? 2 : 0;
    fclose(f);
    return rc;
}

}  // extern "C"
