// Native geometry kernels for the host-side scene build.
//
// The reference implements its entire geometry layer in native (Rust)
// code; this library is the equivalent native runtime for the hot
// host-side loops of this renderer's geometry build: batched Bezier
// evaluation, quadratic glyph tessellation (the text path: 10k-glyph
// scenes are dominated by lines + integral quadratics), polyline arc
// length, and convex hull preparation.  Exposed over a plain C ABI and
// bound with ctypes (no pybind11 in the build image).
//
// Build: see native/build.py (g++ -O3 -shared -fPIC).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// Evaluate rational quadratic curves given power-basis coefficients.
// pb: [n, 3, 3] (w, x, y per row), ts: [m], out: [n, m, 2] projected.
void eval_rational_quadratic(
    const double* pb, int64_t n, const double* ts, int64_t m, double* out) {
    for (int64_t i = 0; i < n; ++i) {
        const double* c = pb + i * 9;
        for (int64_t j = 0; j < m; ++j) {
            const double t = ts[j];
            const double b0 = 1.0, b1 = t, b2 = t * t;
            const double w = b0 * c[0] + b1 * c[3] + b2 * c[6];
            const double x = b0 * c[1] + b1 * c[4] + b2 * c[7];
            const double y = b0 * c[2] + b1 * c[5] + b2 * c[8];
            out[(i * m + j) * 2 + 0] = x / w;
            out[(i * m + j) * 2 + 1] = y / w;
        }
    }
}

// Evaluate rational cubic curves given power-basis coefficients.
// pb: [n, 4, 3], ts: [m], out: [n, m, 2].
void eval_rational_cubic(
    const double* pb, int64_t n, const double* ts, int64_t m, double* out) {
    for (int64_t i = 0; i < n; ++i) {
        const double* c = pb + i * 12;
        for (int64_t j = 0; j < m; ++j) {
            const double t = ts[j];
            const double b1 = t, b2 = t * t, b3 = t * t * t;
            const double w = c[0] + b1 * c[3] + b2 * c[6] + b3 * c[9];
            const double x = c[1] + b1 * c[4] + b2 * c[7] + b3 * c[10];
            const double y = c[2] + b1 * c[5] + b2 * c[8] + b3 * c[11];
            out[(i * m + j) * 2 + 0] = x / w;
            out[(i * m + j) * 2 + 1] = y / w;
        }
    }
}

// Cumulative polyline arc length: points [n, 2] -> out [n] with out[0]=0.
void polyline_arc_length(const double* points, int64_t n, double* out) {
    double acc = 0.0;
    out[0] = 0.0;
    for (int64_t i = 1; i < n; ++i) {
        const double dx = points[i * 2] - points[(i - 1) * 2];
        const double dy = points[i * 2 + 1] - points[(i - 1) * 2 + 1];
        acc += std::sqrt(dx * dx + dy * dy);
        out[i] = acc;
    }
}

// Tessellate a batch of glyph-style paths (lines + integral quadratics).
//
// Inputs (one flattened stream for the whole batch):
//   path_offsets: [num_paths + 1] segment-range per path
//   starts:       [num_paths, 2] path start points
//   seg_kind:     [num_segs] 0 = line, 1 = integral quadratic
//   seg_points:   [num_segs, 4]  line: (x, y, _, _);
//                 quadratic: (cx, cy, x, y)
// Outputs (caller-allocated, capacities = exact sizes precomputable:
//   solid triangles: sum over paths of max(0, points_in_fan - 2)
//   curve triangles: number of quadratic segments):
//   solid_xy:  [max_solid, 3, 2] float32
//   curve_xy:  [max_curve, 3, 2] float32
//   curve_aux: [max_curve, 3, 3] float32 (fixed Loop-Blinn quad coords
//              with the homogeneous third channel = 1)
// Returns number of solid triangles written via out params.
void tessellate_quadratic_paths(
    const int64_t* path_offsets, int64_t num_paths,
    const double* starts,
    const uint8_t* seg_kind, const double* seg_points,
    float* solid_xy, int64_t* solid_count,
    float* curve_xy, float* curve_aux, int64_t* curve_count,
    double* hull_points, int64_t* hull_count) {
    int64_t n_solid = 0, n_curve = 0, n_hull = 0;
    std::vector<double> fan;
    for (int64_t p = 0; p < num_paths; ++p) {
        fan.clear();
        const double sx = starts[p * 2], sy = starts[p * 2 + 1];
        fan.push_back(sx);
        fan.push_back(sy);
        hull_points[n_hull * 2] = sx;
        hull_points[n_hull * 2 + 1] = sy;
        ++n_hull;
        for (int64_t s = path_offsets[p]; s < path_offsets[p + 1]; ++s) {
            const double* q = seg_points + s * 4;
            const double lx = fan[fan.size() - 2], ly = fan[fan.size() - 1];
            if (seg_kind[s] == 0) {
                fan.push_back(q[0]);
                fan.push_back(q[1]);
                hull_points[n_hull * 2] = q[0];
                hull_points[n_hull * 2 + 1] = q[1];
                ++n_hull;
            } else {
                // One Loop-Blinn triangle (start, ctrl, end) with the
                // fixed homogeneous implicit coords (see fill.py).
                float* xy = curve_xy + n_curve * 6;
                float* aux = curve_aux + n_curve * 9;
                xy[0] = (float)lx;  xy[1] = (float)ly;
                xy[2] = (float)q[0]; xy[3] = (float)q[1];
                xy[4] = (float)q[2]; xy[5] = (float)q[3];
                const float coords[9] = {
                    0.0f, 0.0f, 1.0f,
                    0.5f, 0.0f, 1.0f,
                    1.0f, 1.0f, 1.0f,
                };
                std::memcpy(aux, coords, sizeof(coords));
                ++n_curve;
                fan.push_back(q[2]);
                fan.push_back(q[3]);
                hull_points[n_hull * 2] = q[0];
                hull_points[n_hull * 2 + 1] = q[1];
                ++n_hull;
                hull_points[n_hull * 2] = q[2];
                hull_points[n_hull * 2 + 1] = q[3];
                ++n_hull;
            }
        }
        const int64_t fan_points = (int64_t)fan.size() / 2;
        for (int64_t i = 1; i + 1 < fan_points; ++i) {
            float* xy = solid_xy + n_solid * 6;
            xy[0] = (float)fan[0];
            xy[1] = (float)fan[1];
            xy[2] = (float)fan[i * 2];
            xy[3] = (float)fan[i * 2 + 1];
            xy[4] = (float)fan[(i + 1) * 2];
            xy[5] = (float)fan[(i + 1) * 2 + 1];
            ++n_solid;
        }
    }
    *solid_count = n_solid;
    *curve_count = n_curve;
    *hull_count = n_hull;
}

// Andrew's monotone chain over [n, 2] points; out must hold n points.
// Returns hull size.  Collinear points within `margin` (doubled-area
// units) are removed, matching convex_hull.py.
int64_t convex_hull(const double* points, int64_t n, double margin, double* out) {
    if (n < 3) {
        std::memcpy(out, points, (size_t)n * 2 * sizeof(double));
        return n;
    }
    std::vector<int64_t> order(n);
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        if (points[a * 2] != points[b * 2])
            return points[a * 2] < points[b * 2];
        return points[a * 2 + 1] < points[b * 2 + 1];
    });
    auto cross = [&](int64_t o, int64_t a, int64_t b) {
        return (points[a * 2] - points[o * 2]) * (points[b * 2 + 1] - points[o * 2 + 1])
             - (points[a * 2 + 1] - points[o * 2 + 1]) * (points[b * 2] - points[o * 2]);
    };
    std::vector<int64_t> hull;
    for (int64_t k = 0; k < n; ++k) {
        const int64_t i = order[k];
        while (hull.size() > 1 &&
               cross(hull[hull.size() - 2], hull[hull.size() - 1], i) <= margin)
            hull.pop_back();
        hull.push_back(i);
    }
    hull.pop_back();
    const size_t lower = hull.size() + 1;
    for (int64_t k = n - 1; k >= 0; --k) {
        const int64_t i = order[k];
        while (hull.size() + 1 > lower &&
               cross(hull[hull.size() - 2], hull[hull.size() - 1], i) <= margin)
            hull.pop_back();
        hull.push_back(i);
    }
    hull.pop_back();
    for (size_t k = 0; k < hull.size(); ++k) {
        out[k * 2] = points[hull[k] * 2];
        out[k * 2 + 1] = points[hull[k] * 2 + 1];
    }
    return (int64_t)hull.size();
}

}  // extern "C"
