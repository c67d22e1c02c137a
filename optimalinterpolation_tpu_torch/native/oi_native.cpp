// Native host data plane of the PyTorch/CUDA port.
//
// A copy of optimalinterpolation_tpu/native/oi_native.cpp (the JAX package's
// C++ data plane), built and loaded by this package's native/__init__.py so
// the port imports nothing of the JAX package. Plain C ABI, loaded via ctypes:
//
//   * oi_parse_proc       - whitespace-separated float table parser
//                           (replaces np.genfromtxt on .proc track files)
//   * oi_radius_count /   - fixed-radius neighbor search, uniform-grid hash,
//     oi_radius_fill        CSR output (replaces cKDTree.query_ball_point)
//
// Built at first use with g++ -O3 -march=native -fPIC -shared -std=c++17
// into native/_build/ (see native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

// ---------------------------------------------------------------- parser ---

// Parse a whitespace/newline-separated numeric table. Returns a malloc'd
// row-major buffer and sets *rows/*cols; caller frees with oi_free.
// Non-numeric tokens become NaN (np.genfromtxt semantics). Returns nullptr
// on I/O error or ragged rows.
extern "C" double* oi_parse_proc(const char* path, int64_t* rows, int64_t* cols) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> buf(size + 1);
    if (fread(buf.data(), 1, size, f) != (size_t)size) { fclose(f); return nullptr; }
    fclose(f);
    buf[size] = '\0';

    std::vector<double> values;
    values.reserve(size / 8);
    int64_t ncols = -1, cur_cols = 0, nrows = 0;
    char* p = buf.data();
    char* end = buf.data() + size;
    while (p < end) {
        // skip horizontal whitespace
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
        if (p >= end) break;
        if (*p == '\n') {
            if (cur_cols > 0) {
                if (ncols < 0) ncols = cur_cols;
                else if (cur_cols != ncols) return nullptr;  // ragged
                ++nrows;
                cur_cols = 0;
            }
            ++p;
            continue;
        }
        char* next = p;
        double v = strtod(p, &next);
        if (next == p) {  // non-numeric token -> NaN, skip token
            v = NAN;
            while (next < end && *next != ' ' && *next != '\t' &&
                   *next != '\n' && *next != '\r') ++next;
        }
        values.push_back(v);
        ++cur_cols;
        p = next;
    }
    if (cur_cols > 0) {  // last line without trailing newline
        if (ncols < 0) ncols = cur_cols;
        else if (cur_cols != ncols) return nullptr;
        ++nrows;
    }
    if (nrows == 0 || ncols <= 0) { *rows = 0; *cols = 0; return nullptr; }
    double* out = (double*)malloc(sizeof(double) * values.size());
    memcpy(out, values.data(), sizeof(double) * values.size());
    *rows = nrows;
    *cols = ncols;
    return out;
}

extern "C" void oi_free(double* ptr) { free(ptr); }

// -------------------------------------------------- radius neighbor search ---

// Uniform-grid spatial hash over the training points with bin size = radius:
// every query only inspects its 3x3 bin neighborhood. Two-phase CSR API so
// the caller owns all allocations (numpy arrays across ctypes).

struct Hash {
    double minx, miny, inv;
    int64_t nx, ny;
    std::vector<int64_t> starts;   // bin -> start into order
    std::vector<int64_t> order;    // point indices grouped by bin
};

static Hash build_hash(const double* pts, int64_t n, double radius) {
    Hash h;
    h.minx = 1e300; h.miny = 1e300;
    double maxx = -1e300, maxy = -1e300;
    for (int64_t i = 0; i < n; ++i) {
        h.minx = std::min(h.minx, pts[2 * i]);
        maxx = std::max(maxx, pts[2 * i]);
        h.miny = std::min(h.miny, pts[2 * i + 1]);
        maxy = std::max(maxy, pts[2 * i + 1]);
    }
    double cell = radius > 0 ? radius : 1.0;
    h.inv = 1.0 / cell;
    h.nx = std::max<int64_t>(1, (int64_t)((maxx - h.minx) * h.inv) + 1);
    h.ny = std::max<int64_t>(1, (int64_t)((maxy - h.miny) * h.inv) + 1);
    std::vector<int64_t> count(h.nx * h.ny + 1, 0);
    std::vector<int64_t> bin(n);
    for (int64_t i = 0; i < n; ++i) {
        int64_t bx = (int64_t)((pts[2 * i] - h.minx) * h.inv);
        int64_t by = (int64_t)((pts[2 * i + 1] - h.miny) * h.inv);
        bin[i] = bx * h.ny + by;
        ++count[bin[i] + 1];
    }
    for (size_t b = 1; b < count.size(); ++b) count[b] += count[b - 1];
    h.order.resize(n);
    std::vector<int64_t> cursor(count.begin(), count.end() - 1);
    for (int64_t i = 0; i < n; ++i) h.order[cursor[bin[i]]++] = i;
    h.starts = std::move(count);
    return h;
}

template <typename F>
static void for_each_neighbor(const Hash& h, const double* pts,
                              double qx, double qy, double r2, F&& fn) {
    int64_t bx = (int64_t)((qx - h.minx) * h.inv);
    int64_t by = (int64_t)((qy - h.miny) * h.inv);
    for (int64_t dx = -1; dx <= 1; ++dx) {
        int64_t cx = bx + dx;
        if (cx < 0 || cx >= h.nx) continue;
        for (int64_t dy = -1; dy <= 1; ++dy) {
            int64_t cy = by + dy;
            if (cy < 0 || cy >= h.ny) continue;
            int64_t b = cx * h.ny + cy;
            for (int64_t k = h.starts[b]; k < h.starts[b + 1]; ++k) {
                int64_t i = h.order[k];
                double ddx = pts[2 * i] - qx, ddy = pts[2 * i + 1] - qy;
                if (ddx * ddx + ddy * ddy <= r2) fn(i);
            }
        }
    }
}

// counts[m]: number of points within `radius` of each query cell.
extern "C" void oi_radius_count(const double* pts, int64_t n,
                     const double* cells, int64_t m,
                     double radius, int64_t* counts) {
    Hash h = build_hash(pts, n, radius);
    double r2 = radius * radius;
    for (int64_t c = 0; c < m; ++c) {
        int64_t cnt = 0;
        for_each_neighbor(h, pts, cells[2 * c], cells[2 * c + 1], r2,
                          [&](int64_t) { ++cnt; });
        counts[c] = cnt;
    }
}

// offsets[m+1] (exclusive prefix sum of counts) and out[total] filled with
// neighbor indices, sorted ascending per cell (cKDTree order-compatible).
extern "C" void oi_radius_fill(const double* pts, int64_t n,
                    const double* cells, int64_t m,
                    double radius, const int64_t* offsets, int64_t* out) {
    Hash h = build_hash(pts, n, radius);
    double r2 = radius * radius;
    for (int64_t c = 0; c < m; ++c) {
        int64_t pos = offsets[c];
        for_each_neighbor(h, pts, cells[2 * c], cells[2 * c + 1], r2,
                          [&](int64_t i) { out[pos++] = i; });
        std::sort(out + offsets[c], out + pos);
    }
}
