// The QR locator of OpenCV's ``cv2.QRCodeDetector`` (objdetect's QRDetect and
// QRDetectMulti, as OpenCV 5.0 builds them), rebuilt step by step in plain
// C++ for the port's QR scan, with the OpenCV primitives it runs on:
//
// - cv::RNG (multiply with carry) and ``theRNG()``'s per-thread state;
// - cv::kmeans with KMEANS_PP_CENTERS (float32 points, 2 dimensions);
// - adaptiveThreshold(ADAPTIVE_THRESH_GAUSSIAN_C, THRESH_BINARY): a float32
//   Gaussian blur over replicated edges, rounded to uint8, then the table;
// - resize with INTER_LINEAR_EXACT (8-bit fixed point) on uint8;
// - blur 3x3, threshold and findContours(RETR_TREE, CHAIN_APPROX_SIMPLE);
// - floodFill (mask only, 4-connected, zero range), findNonZero, convexHull
//   (Sklansky, int and float points), contourArea, pointPolygonTest with
//   distance, and LineIterator with clipLine.
//
// Every float expression keeps OpenCV's types and order (float where OpenCV
// computes in float, double where it promotes). No multiply-add is fused, as
// in OpenCV's baseline build of these files, but where OpenCV's dispatched
// filter loops fuse them (the Gaussian's vector lanes). ``qr_detect_multi`` and
// ``qr_detect`` return what ``detectMulti`` and ``detect`` return; the
// remaining entry points expose each primitive for tests.

#if defined(__clang__)
#pragma clang fp contract(off)
#elif defined(__GNUC__)
#pragma GCC optimize("fp-contract=off")
#endif

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <utility>
#include <vector>

namespace {

// ----------------------------------------------------------------- basics

struct P2f {
    float x, y;
    P2f() : x(0.f), y(0.f) {}
    P2f(float x_, float y_) : x(x_), y(y_) {}
};
struct P2i {
    int x, y;
    P2i() : x(0), y(0) {}
    P2i(int x_, int y_) : x(x_), y(y_) {}
};

inline P2f operator-(P2f a, P2f b) { return P2f(a.x - b.x, a.y - b.y); }
inline bool operator==(P2f a, P2f b) { return a.x == b.x && a.y == b.y; }
inline bool operator==(P2i a, P2i b) { return a.x == b.x && a.y == b.y; }

// cvRound: round half to even; out of range or NaN gives INT_MIN, as the
// x86 conversion instructions do
inline int cv_round(double v) {
    if (!(v >= -2147483648.0 && v < 2147483648.0)) return INT32_MIN;
    return (int)std::nearbyint(v);
}
inline int cv_round_f(float v) { return cv_round((double)v); }
inline P2i to_point(P2f p) { return P2i(cv_round_f(p.x), cv_round_f(p.y)); }
inline P2f to_point2f(P2i p) { return P2f((float)p.x, (float)p.y); }

// cv::norm of a Point2f: the float components squared in double
inline double norm2f(P2f d) {
    return std::sqrt((double)d.x * d.x + (double)d.y * d.y);
}

struct Img {
    int rows = 0, cols = 0;
    std::vector<uint8_t> d;
    Img() {}
    Img(int r, int c, uint8_t v = 0) : rows(r), cols(c), d((size_t)r * c, v) {}
    uint8_t& at(int y, int x) { return d[(size_t)y * cols + x]; }
    uint8_t at(int y, int x) const { return d[(size_t)y * cols + x]; }
    const uint8_t* row(int y) const { return d.data() + (size_t)y * cols; }
    bool empty() const { return d.empty(); }
};

// ------------------------------------------------------------------- RNG

thread_local uint64_t rng_state = 0xffffffffULL;

inline unsigned rng_next() {
    rng_state = (uint64_t)(unsigned)rng_state * 4164903690ULL + (unsigned)(rng_state >> 32);
    return (unsigned)rng_state;
}
// RNG::operator double(): two draws, high word first
inline double rng_double() {
    unsigned t = rng_next();
    return (double)(((uint64_t)t << 32) | rng_next()) * 5.4210108624275221700372640043497e-20;
}

// --------------------------------------------------------------- k-means

inline float norm_l2_sqr(const float* a, const float* b) {
    float d = 0.f;
    for (int j = 0; j < 2; j++) {
        float t = a[j] - b[j];
        d += t * t;
    }
    return d;
}

void generate_centers_pp(const std::vector<P2f>& data, std::vector<P2f>& out, int K, int trials) {
    const int N = (int)data.size();
    std::vector<int> centers(K);
    std::vector<float> buf((size_t)N * 3);
    float* dist = buf.data();
    float* tdist = dist + N;
    float* tdist2 = tdist + N;
    double sum0 = 0;
    const float* pts = &data[0].x;

    centers[0] = (int)(rng_next() % (unsigned)N);
    for (int i = 0; i < N; i++) {
        dist[i] = norm_l2_sqr(pts + 2 * i, pts + 2 * centers[0]);
        sum0 += dist[i];
    }
    for (int k = 1; k < K; k++) {
        double best_sum = DBL_MAX;
        int best_center = -1;
        for (int j = 0; j < trials; j++) {
            double p = rng_double() * sum0;
            int ci = 0;
            for (; ci < N - 1; ci++) {
                p -= dist[ci];
                if (p <= 0) break;
            }
            for (int i = 0; i < N; i++)
                tdist2[i] = std::min(norm_l2_sqr(pts + 2 * i, pts + 2 * ci), dist[i]);
            double s = 0;
            for (int i = 0; i < N; i++) s += tdist2[i];
            if (s < best_sum) {
                best_sum = s;
                best_center = ci;
                std::swap(tdist, tdist2);
            }
        }
        if (best_center < 0) best_center = 0;  // OpenCV raises: NaN or huge input
        centers[k] = best_center;
        sum0 = best_sum;
        std::swap(dist, tdist);
    }
    out.resize(K);
    for (int k = 0; k < K; k++) out[k] = data[centers[k]];
}

// cv::kmeans(data, K, labels, TermCriteria(EPS + COUNT, max_count, epsilon),
// attempts, KMEANS_PP_CENTERS, centers) → compactness
double kmeans_pp(const std::vector<P2f>& data, int K, int max_count, double epsilon, int attempts,
                 std::vector<int>& best_labels, std::vector<P2f>& best_centers) {
    const int N = (int)data.size();
    attempts = std::max(attempts, 1);
    epsilon = std::max(epsilon, 0.);
    epsilon *= epsilon;
    max_count = std::min(std::max(max_count, 2), 100);
    if (K == 1) {
        attempts = 1;
        max_count = 2;
    }
    std::vector<int> labels(N, 0);
    best_labels.assign(N, 0);
    std::vector<P2f> centers(K), old_centers(K);
    std::vector<int> counters(K);
    std::vector<double> dists(N);
    double best_compactness = DBL_MAX;
    const float* pts = &data[0].x;

    for (int a = 0; a < attempts; a++) {
        double compactness = 0;
        for (int iter = 0;;) {
            double max_center_shift = iter == 0 ? DBL_MAX : 0.0;
            std::swap(centers, old_centers);
            if (iter == 0) {
                generate_centers_pp(data, centers, K, 3);
            } else {
                for (int k = 0; k < K; k++) {
                    centers[k] = P2f(0.f, 0.f);
                    counters[k] = 0;
                }
                for (int i = 0; i < N; i++) {
                    int k = labels[i];
                    centers[k].x += data[i].x;
                    centers[k].y += data[i].y;
                    counters[k]++;
                }
                for (int k = 0; k < K; k++) {
                    if (counters[k] != 0) continue;
                    int max_k = 0;
                    for (int k1 = 1; k1 < K; k1++)
                        if (counters[max_k] < counters[k1]) max_k = k1;
                    double max_dist = 0;
                    int farthest_i = -1;
                    P2f& base_center = centers[max_k];
                    float scale = 1.f / counters[max_k];
                    float base[2] = {base_center.x * scale, base_center.y * scale};
                    for (int i = 0; i < N; i++) {
                        if (labels[i] != max_k) continue;
                        double dist = norm_l2_sqr(pts + 2 * i, base);
                        if (max_dist <= dist) {
                            max_dist = dist;
                            farthest_i = i;
                        }
                    }
                    counters[max_k]--;
                    counters[k]++;
                    labels[farthest_i] = k;
                    base_center.x -= data[farthest_i].x;
                    base_center.y -= data[farthest_i].y;
                    centers[k].x += data[farthest_i].x;
                    centers[k].y += data[farthest_i].y;
                }
                for (int k = 0; k < K; k++) {
                    float scale = 1.f / counters[k];
                    centers[k].x *= scale;
                    centers[k].y *= scale;
                    if (iter > 0) {
                        double dist = 0;
                        double t = centers[k].x - old_centers[k].x;
                        dist += t * t;
                        t = centers[k].y - old_centers[k].y;
                        dist += t * t;
                        max_center_shift = std::max(max_center_shift, dist);
                    }
                }
            }
            bool last = (++iter == std::max(max_count, 2) || max_center_shift <= epsilon);
            if (last) {
                for (int i = 0; i < N; i++)
                    dists[i] = norm_l2_sqr(pts + 2 * i, &centers[labels[i]].x);
                // cv::sum of a CV_64F row: four values a step, then the rest
                double s0 = 0;
                int i = 0;
                for (; i <= N - 4; i += 4) s0 += dists[i] + dists[i + 1] + dists[i + 2] + dists[i + 3];
                for (; i < N; i++) s0 += dists[i];
                compactness = s0;
                break;
            }
            for (int i = 0; i < N; i++) {
                int k_best = 0;
                double min_dist = DBL_MAX;
                for (int k = 0; k < K; k++) {
                    double dist = norm_l2_sqr(pts + 2 * i, &centers[k].x);
                    if (min_dist > dist) {
                        min_dist = dist;
                        k_best = k;
                    }
                }
                dists[i] = min_dist;
                labels[i] = k_best;
            }
        }
        if (compactness < best_compactness) {
            best_compactness = compactness;
            best_centers = centers;
            best_labels = labels;
        }
    }
    return best_compactness;
}

// ----------------------------------------------------- adaptive threshold

// getGaussianKernel(n, 0, CV_32F): the bit-exact double kernel rounded to float
std::vector<float> gaussian_kernel_f32(int n) {
    double sigma = std::fma((double)n, 0.15, 0.35);
    double scale2 = -0.125 / (sigma * sigma);
    int half = (n - 1) / 2;
    std::vector<double> values(half);
    double sum = 0;
    for (int i = 0, x = 1 - n; i < half; i++, x += 2) {
        double t = std::exp((double)(x * x) * scale2);
        values[i] = t;
        sum += t;
    }
    sum *= 2;
    sum += 1;
    double mul = 1.0 / sum;
    std::vector<float> k(n);
    for (int i = 0; i < half; i++) k[i] = k[n - 1 - i] = (float)(values[i] * mul);
    k[half] = (float)(1.0 * mul);
    return k;
}

// The fused multiply-adds of OpenCV's vector loops: acc[x] = fma(a[x] (+
// b[x]), k, acc[x]). On x86 they use the FMA instructions where the CPU has
// them (``std::fma`` is exact everywhere, but a library call on x86).
#if defined(__x86_64__) && defined(__GNUC__)
__attribute__((target("avx2,fma"), optimize("O3"))) void fma_row_hw(float* __restrict acc, const float* __restrict a,
                                                                   float k, int n) {
    for (int x = 0; x < n; x++) acc[x] = __builtin_fmaf(a[x], k, acc[x]);
}
__attribute__((target("avx2,fma"), optimize("O3"))) void fma_pair_hw(float* __restrict acc, const float* __restrict a,
                                                                    const float* __restrict b, float k, int n) {
    for (int x = 0; x < n; x++) acc[x] = __builtin_fmaf(a[x] + b[x], k, acc[x]);
}
bool cpu_has_fma() {
    __builtin_cpu_init();  // static initialisers may run before the CPU model is read
    return __builtin_cpu_supports("fma") && __builtin_cpu_supports("avx2");
}
const bool have_hw_fma = cpu_has_fma();
#else
const bool have_hw_fma = false;
void fma_row_hw(float*, const float*, float, int) {}
void fma_pair_hw(float*, const float*, const float*, float, int) {}
#endif

void fma_row(float* acc, const float* a, float k, int n) {
    if (have_hw_fma) return fma_row_hw(acc, a, k, n);
    for (int x = 0; x < n; x++) acc[x] = std::fma(a[x], k, acc[x]);
}
void fma_pair(float* acc, const float* a, const float* b, float k, int n) {
    if (have_hw_fma) return fma_pair_hw(acc, a, b, k, n);
    for (int x = 0; x < n; x++) acc[x] = std::fma(a[x] + b[x], k, acc[x]);
}

// GaussianBlur(float32 of src, (n, n), 0, BORDER_REPLICATE): rows as an FMA
// chain from zero, 8 lanes and then 4 at a time, the last W % 4 values of
// each row without FMAs; columns the centre tap, then each symmetric pair
// summed before its FMA, 8 lanes at a time, the last W % 8 values without
// FMAs
void gaussian_blur_replicate_f32(const Img& src, int n, std::vector<float>& out) {
    const int h = src.rows, w = src.cols, r = n / 2;
    std::vector<float> k = gaussian_kernel_f32(n);
    std::vector<float> rows((size_t)h * w);
    std::vector<float> pad(w + 2 * r);
    const int vec_end = w - w % 8;
    const int row_vec_end = w - w % 4;
    for (int y = 0; y < h; y++) {
        const uint8_t* s = src.row(y);
        for (int i = 0; i < w + 2 * r; i++) pad[i] = (float)s[std::min(std::max(i - r, 0), w - 1)];
        float* o = rows.data() + (size_t)y * w;
        std::fill(o, o + row_vec_end, 0.f);
        for (int j = 0; j < n; j++) fma_row(o, pad.data() + j, k[j], row_vec_end);
        for (int x = row_vec_end; x < w; x++) {
            float acc = k[0] * pad[x];
            for (int j = 1; j < n; j++) acc = acc + k[j] * pad[x + j];
            o[x] = acc;
        }
    }
    out.assign((size_t)h * w, 0.f);
    auto R = [&](int yy) { return rows.data() + (size_t)std::min(std::max(yy, 0), h - 1) * w; };
    for (int y = 0; y < h; y++) {
        float* o = out.data() + (size_t)y * w;
        const float* c = R(y);
        for (int x = 0; x < w; x++) o[x] = c[x] * k[r];
        for (int t = 1; t <= r; t++) {
            const float* a = R(y + t);
            const float* b = R(y - t);
            const float kt = k[r + t];
            fma_pair(o, a, b, kt, vec_end);
            for (int x = vec_end; x < w; x++) o[x] = o[x] + kt * (b[x] + a[x]);
        }
    }
}

inline uint8_t sat_u8_round(float v) {
    int iv = cv_round_f(v);
    return (uint8_t)std::min(std::max(iv, 0), 255);
}

// adaptiveThreshold(src, 255, ADAPTIVE_THRESH_GAUSSIAN_C, THRESH_BINARY, block, c)
Img adaptive_threshold(const Img& src, int block, double c) {
    std::vector<float> mean;
    gaussian_blur_replicate_f32(src, block, mean);
    int idelta = (int)std::ceil(c);
    Img dst(src.rows, src.cols);
    for (size_t i = 0; i < src.d.size(); i++) {
        int m = sat_u8_round(mean[i]);
        dst.d[i] = ((int)src.d[i] - m > -idelta) ? 255 : 0;
    }
    return dst;
}

// ------------------------------------------------------------------ resize

// resize(src, (dw, dh), 0, 0, INTER_LINEAR_EXACT) on uint8: Q8 coefficients,
// a horizontal pass kept in Q8 and a vertical one rounded from Q16. An
// exact halving in both directions is INTER_AREA's 2x2 mean, as in OpenCV.
Img resize_linear_exact(const Img& src, int dw, int dh) {
    const int sw = src.cols, sh = src.rows;
    if (dw == sw && dh == sh) return src;
    double inv_x = (double)dw / sw, inv_y = (double)dh / sh;
    double scale_x = 1. / inv_x, scale_y = 1. / inv_y;
    int iscale_x = cv_round(scale_x), iscale_y = cv_round(scale_y);
    bool area_fast = std::abs(scale_x - iscale_x) < DBL_EPSILON && std::abs(scale_y - iscale_y) < DBL_EPSILON;
    Img dst(dh, dw);
    if (area_fast && iscale_x == 2 && iscale_y == 2) {
        for (int y = 0; y < dh; y++) {
            const uint8_t* a = src.row(2 * y);
            const uint8_t* b = src.row(2 * y + 1);
            for (int x = 0; x < dw; x++)
                dst.at(y, x) = (uint8_t)((a[2 * x] + a[2 * x + 1] + b[2 * x] + b[2 * x + 1] + 2) >> 2);
        }
        return dst;
    }
    struct Axis {
        std::vector<int> ofs;
        std::vector<uint32_t> c0, c1;
        int minofs = 0, maxofs;
    };
    auto coeffs = [](double inv, int ssize, int dsize) {
        Axis a;
        a.maxofs = dsize;
        a.ofs.assign(dsize, 0);
        a.c0.assign(dsize, 256);
        a.c1.assign(dsize, 0);
        double scale = 1.0 / inv;
        for (int v = 0; v < dsize; v++) {
            double f = scale * ((double)v + 0.5) - 0.5;
            int iv = (int)std::floor(f);
            if (iv >= 0 && ssize > 1) {
                if (iv < ssize - 1) {
                    a.ofs[v] = iv;
                    uint32_t c1 = (uint32_t)cv_round((f - (double)iv) * 256.0);
                    a.c1[v] = c1;
                    a.c0[v] = 256 - c1;
                } else {
                    a.ofs[v] = ssize - 1;
                    a.maxofs = std::min(a.maxofs, v);
                }
            } else {
                a.minofs = std::max(a.minofs, v + 1);
            }
        }
        return a;
    };
    Axis ax = coeffs(inv_x, sw, dw), ay = coeffs(inv_y, sh, dh);
    auto hline = [&](int sy, std::vector<uint32_t>& line) {
        const uint8_t* s = src.row(sy);
        for (int x = 0; x < dw; x++) {
            if (x < ax.minofs) line[x] = (uint32_t)s[0] << 8;
            else if (x >= ax.maxofs) line[x] = (uint32_t)s[ax.ofs[dw - 1]] << 8;
            else line[x] = ax.c0[x] * s[ax.ofs[x]] + ax.c1[x] * s[ax.ofs[x] + 1];
        }
    };
    std::vector<uint32_t> l0(dw), l1(dw);
    for (int y = 0; y < dh; y++) {
        uint8_t* o = dst.d.data() + (size_t)y * dw;
        if (y < ay.minofs || y >= ay.maxofs) {
            hline(y < ay.minofs ? 0 : sh - 1, l0);
            for (int x = 0; x < dw; x++) o[x] = (uint8_t)std::min<uint32_t>((l0[x] + 128) >> 8, 255);
        } else {
            hline(ay.ofs[y], l0);
            hline(ay.ofs[y] + 1, l1);
            uint64_t c0 = ay.c0[y], c1 = ay.c1[y];
            for (int x = 0; x < dw; x++)
                o[x] = (uint8_t)std::min<uint64_t>((c0 * l0[x] + c1 * l1[x] + 32768) >> 16, 255);
        }
    }
    return dst;
}

// -------------------------------------------------------- line iterator

bool clip_line(int w, int h, int64_t& x1, int64_t& y1, int64_t& x2, int64_t& y2) {
    int64_t right = w - 1, bottom = h - 1;
    if (w <= 0 || h <= 0) return false;
    int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
    int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
        int64_t a;
        if (c1 & 12) {
            a = c1 < 8 ? 0 : bottom;
            x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
            y1 = a;
            c1 = (x1 < 0) + (x1 > right) * 2;
        }
        if (c2 & 12) {
            a = c2 < 8 ? 0 : bottom;
            x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
            y2 = a;
            c2 = (x2 < 0) + (x2 > right) * 2;
        }
        if ((c1 & c2) == 0 && (c1 | c2) != 0) {
            if (c1) {
                a = c1 == 1 ? 0 : right;
                y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
                x1 = a;
                c1 = 0;
            }
            if (c2) {
                a = c2 == 1 ? 0 : right;
                y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
                x2 = a;
                c2 = 0;
            }
        }
    }
    return (c1 | c2) == 0;
}

// LineIterator(img, p1, p2, 8, leftToRight = false): its pixels in order,
// the line clipped to the w x h image; ``clip`` false is LineIterator(p1, p2),
// the whole line
std::vector<P2i> line_points(int w, int h, P2i p1, P2i p2, bool clip = true) {
    std::vector<P2i> out;
    if (clip && ((unsigned)p1.x >= (unsigned)w || (unsigned)p2.x >= (unsigned)w ||
                 (unsigned)p1.y >= (unsigned)h || (unsigned)p2.y >= (unsigned)h)) {
        int64_t x1 = p1.x, y1 = p1.y, x2 = p2.x, y2 = p2.y;
        if (!clip_line(w, h, x1, y1, x2, y2)) return out;
        p1 = P2i((int)x1, (int)y1);
        p2 = P2i((int)x2, (int)y2);
    }
    int delta_x = 1, delta_y = 1;
    int dx = p2.x - p1.x, dy = p2.y - p1.y;
    if (dx < 0) {
        dx = -dx;
        delta_x = -1;
    }
    if (dy < 0) {
        dy = -dy;
        delta_y = -1;
    }
    bool vert = dy > dx;
    if (vert) {
        std::swap(dx, dy);
        std::swap(delta_x, delta_y);
    }
    int err = dx - (dy + dy);
    int plus_delta = dx + dx, minus_delta = -(dy + dy);
    // minus step: along the major axis; plus: also across it
    int mx = delta_x, my = 0, px = 0, py = delta_y;
    if (vert) {
        std::swap(mx, my);
        std::swap(px, py);
    }
    int count = dx + 1;
    out.reserve(count);
    int x = p1.x, y = p1.y;
    for (int i = 0; i < count; i++) {
        out.push_back(P2i(x, y));
        int mask = err < 0 ? -1 : 0;
        err += minus_delta + (plus_delta & mask);
        x += mx + (px & mask);
        y += my + (py & mask);
    }
    return out;
}

// ---------------------------------------------------------- geometry

double contour_area(const std::vector<P2f>& pts) {
    const int n = (int)pts.size();
    if (n == 0) return 0.;
    double a00 = 0;
    P2f prev = pts[n - 1];
    for (int i = 0; i < n; i++) {
        P2f p = pts[i];
        a00 += (double)prev.x * p.y - (double)prev.y * p.x;
        prev = p;
    }
    return std::fabs(a00 * 0.5);
}

// pointPolygonTest(contour, pt, true) for a float32 contour
double point_polygon_test(const std::vector<P2f>& cnt, P2f pt) {
    const int total = (int)cnt.size();
    if (total == 0) return -1.;
    int counter = 0;
    double min_dist_num = FLT_MAX, min_dist_denom = 1;
    P2f v0, v = cnt[total - 1];
    for (int i = 0; i < total; i++) {
        double dx, dy, dx1, dy1, dx2, dy2, dist_num, dist_denom = 1;
        v0 = v;
        v = cnt[i];
        dx = v.x - v0.x;
        dy = v.y - v0.y;
        dx1 = pt.x - v0.x;
        dy1 = pt.y - v0.y;
        dx2 = pt.x - v.x;
        dy2 = pt.y - v.y;
        if (dx1 * dx + dy1 * dy <= 0)
            dist_num = dx1 * dx1 + dy1 * dy1;
        else if (dx2 * dx + dy2 * dy >= 0)
            dist_num = dx2 * dx2 + dy2 * dy2;
        else {
            dist_num = (dy1 * dx - dx1 * dy);
            dist_num *= dist_num;
            dist_denom = dx * dx + dy * dy;
        }
        if (dist_num * min_dist_denom < min_dist_num * dist_denom) {
            min_dist_num = dist_num;
            min_dist_denom = dist_denom;
            if (min_dist_num == 0) break;
        }
        if ((v0.y <= pt.y && v.y <= pt.y) || (v0.y > pt.y && v.y > pt.y) || (v0.x < pt.x && v.x < pt.x))
            continue;
        dist_num = dy1 * dx - dx1 * dy;
        if (dy < 0) dist_num = -dist_num;
        counter += dist_num > 0;
    }
    double result = std::sqrt(min_dist_num / min_dist_denom);
    if (counter % 2 == 0) result = -result;
    return result;
}

template <typename T>
inline int sign_of(T v) {
    return (v > 0) - (v < 0);
}

template <typename T, typename DotT>
int sklansky(const std::vector<const T*>& array, int start, int end, int* stack, int nsign, int sign2) {
    int incr = end > start ? 1 : -1;
    int pprev = start, pcur = pprev + incr, pnext = pcur + incr;
    int stacksize = 3;
    if (start == end || (array[start]->x == array[end]->x && array[start]->y == array[end]->y)) {
        stack[0] = start;
        return 1;
    }
    stack[0] = pprev;
    stack[1] = pcur;
    stack[2] = pnext;
    end += incr;
    while (pnext != end) {
        auto cury = array[pcur]->y;
        auto nexty = array[pnext]->y;
        auto by = nexty - cury;
        if (sign_of(by) != nsign) {
            auto ax = array[pcur]->x - array[pprev]->x;
            auto bx = array[pnext]->x - array[pcur]->x;
            auto ay = cury - array[pprev]->y;
            DotT convexity = (DotT)ay * bx - (DotT)ax * by;
            if (sign_of(convexity) == sign2 && (ax != 0 || ay != 0)) {
                pprev = pcur;
                pcur = pnext;
                pnext += incr;
                stack[stacksize] = pnext;
                stacksize++;
            } else {
                if (pprev == start) {
                    pcur = pnext;
                    stack[1] = pcur;
                    pnext += incr;
                    stack[2] = pnext;
                } else {
                    stack[stacksize - 2] = pnext;
                    pcur = pprev;
                    pprev = stack[stacksize - 4];
                    stacksize--;
                }
            }
        } else {
            pnext += incr;
            stack[stacksize - 1] = pnext;
        }
    }
    return --stacksize;
}

// convexHull(points, hull, clockwise = false, returnPoints = true) → indices
template <typename T, typename DotT>
std::vector<int> convex_hull_idx(const std::vector<T>& pts) {
    const int total = (int)pts.size();
    std::vector<int> hull;
    if (total == 0) return hull;
    std::vector<const T*> pointer(total);
    for (int i = 0; i < total; i++) pointer[i] = &pts[i];
    std::sort(pointer.begin(), pointer.end(), [](const T* p1, const T* p2) {
        if (p1->x != p2->x) return p1->x < p2->x;
        if (p1->y != p2->y) return p1->y < p2->y;
        return p1 < p2;
    });
    int miny_ind = 0, maxy_ind = 0;
    for (int i = 1; i < total; i++) {
        auto y = pointer[i]->y;
        if (pointer[miny_ind]->y > y) miny_ind = i;
        if (pointer[maxy_ind]->y < y) maxy_ind = i;
    }
    std::vector<int> stackbuf(total + 2), hullbuf(total);
    int* stack = stackbuf.data();
    int nout = 0;
    const T* data0 = pts.data();
    if (pointer[0]->x == pointer[total - 1]->x && pointer[0]->y == pointer[total - 1]->y) {
        hullbuf[nout++] = 0;
    } else {
        int* tl_stack = stack;
        int tl_count = sklansky<T, DotT>(pointer, 0, maxy_ind, tl_stack, -1, 1);
        int* tr_stack = stack + tl_count;
        int tr_count = sklansky<T, DotT>(pointer, total - 1, maxy_ind, tr_stack, -1, -1);
        // counter-clockwise
        std::swap(tl_stack, tr_stack);
        std::swap(tl_count, tr_count);
        for (int i = 0; i < tl_count - 1; i++) hullbuf[nout++] = (int)(pointer[tl_stack[i]] - data0);
        for (int i = tr_count - 1; i > 0; i--) hullbuf[nout++] = (int)(pointer[tr_stack[i]] - data0);
        int stop_idx = tr_count > 2 ? tr_stack[1] : tl_count > 2 ? tl_stack[tl_count - 2] : -1;

        int* bl_stack = stack;
        int bl_count = sklansky<T, DotT>(pointer, 0, miny_ind, bl_stack, 1, -1);
        int* br_stack = stack + bl_count;
        int br_count = sklansky<T, DotT>(pointer, total - 1, miny_ind, br_stack, 1, 1);
        if (stop_idx >= 0) {
            int check_idx = bl_count > 2 ? bl_stack[1] : bl_count + br_count > 2 ? br_stack[2 - bl_count] : -1;
            if (check_idx == stop_idx ||
                (check_idx >= 0 && pointer[check_idx]->x == pointer[stop_idx]->x &&
                 pointer[check_idx]->y == pointer[stop_idx]->y)) {
                bl_count = std::min(bl_count, 2);
                br_count = std::min(br_count, 2);
            }
        }
        for (int i = 0; i < bl_count - 1; i++) hullbuf[nout++] = (int)(pointer[bl_stack[i]] - data0);
        for (int i = br_count - 1; i > 0; i--) hullbuf[nout++] = (int)(pointer[br_stack[i]] - data0);

        if (nout >= 3) {
            int min_idx = 0, max_idx = 0, lt = 0;
            for (int i = 1; i < nout; i++) {
                int idx = hullbuf[i];
                lt += hullbuf[i - 1] < idx;
                if (lt > 1 && lt <= i - 2) break;
                if (idx < hullbuf[min_idx]) min_idx = i;
                if (idx > hullbuf[max_idx]) max_idx = i;
            }
            int mmdist = std::abs(max_idx - min_idx);
            if ((mmdist == 1 || mmdist == nout - 1) && (lt <= 1 || lt >= nout - 2)) {
                int ascending = (max_idx + 1) % nout == min_idx;
                int i0 = ascending ? min_idx : max_idx, j = i0;
                if (i0 > 0) {
                    int i;
                    for (i = 0; i < nout; i++) {
                        int curr_idx = stack[i] = hullbuf[j];
                        int next_j = j + 1 < nout ? j + 1 : 0;
                        int next_idx = hullbuf[next_j];
                        if (i < nout - 1 && (ascending != (curr_idx < next_idx))) break;
                        j = next_j;
                    }
                    if (i == nout) std::memcpy(hullbuf.data(), stack, nout * sizeof(int));
                }
            }
        }
    }
    hull.assign(hullbuf.begin(), hullbuf.begin() + nout);
    return hull;
}

std::vector<P2i> convex_hull_i(const std::vector<P2i>& pts) {
    std::vector<P2i> out;
    for (int i : convex_hull_idx<P2i, int64_t>(pts)) out.push_back(pts[i]);
    return out;
}

std::vector<P2f> convex_hull_f(const std::vector<P2f>& pts) {
    std::vector<P2f> out;
    for (int i : convex_hull_idx<P2f, double>(pts)) out.push_back(pts[i]);
    return out;
}

// floodFill(img, mask, seed, 255, 0, Scalar(), Scalar(), FLOODFILL_MASK_ONLY):
// marks with 1 in the (rows + 2) x (cols + 2) mask the 4-connected pixels of
// the seed's value whose mask is 0
void flood_fill_mask(const Img& img, Img& mask, P2i seed, std::vector<P2i>* filled = nullptr) {
    const int w = img.cols, h = img.rows;
    if ((unsigned)seed.x >= (unsigned)w || (unsigned)seed.y >= (unsigned)h) return;
    const uint8_t v = img.at(seed.y, seed.x);
    auto M = [&](int y, int x) -> uint8_t& { return mask.at(y + 1, x + 1); };
    if (M(seed.y, seed.x)) return;
    std::vector<P2i> stack;
    stack.push_back(seed);
    M(seed.y, seed.x) = 1;
    while (!stack.empty()) {
        P2i p = stack.back();
        stack.pop_back();
        if (filled) filled->push_back(p);
        const int nx[4] = {p.x + 1, p.x - 1, p.x, p.x};
        const int ny[4] = {p.y, p.y, p.y + 1, p.y - 1};
        for (int k = 0; k < 4; k++) {
            int x = nx[k], y = ny[k];
            if ((unsigned)x >= (unsigned)w || (unsigned)y >= (unsigned)h) continue;
            if (M(y, x) || img.at(y, x) != v) continue;
            M(y, x) = 1;
            stack.push_back(P2i(x, y));
        }
    }
}

Img new_fill_mask(int rows, int cols) {
    Img m(rows + 2, cols + 2, 0);
    for (int x = 0; x < cols + 2; x++) m.at(0, x) = m.at(rows + 1, x) = 1;
    for (int y = 0; y < rows + 2; y++) m.at(y, 0) = m.at(y, cols + 1) = 1;
    return m;
}

// findNonZero(mask(Range(1, rows - 1), Range(1, cols - 1))) of a fill mask
// whose filled pixels are ``filled``: those in the window, row by row
std::vector<P2i> mask_roi_nonzero(std::vector<P2i> filled, int rows, int cols) {
    std::vector<P2i> out;
    for (const P2i& p : filled)
        if (p.y < rows - 2 && p.x < cols - 2) out.push_back(p);
    std::sort(out.begin(), out.end(), [](const P2i& a, const P2i& b) { return a.y != b.y ? a.y < b.y : a.x < b.x; });
    return out;
}

// -------------------------------------------------------------- contours

// findContours(img != 0, RETR_TREE, CHAIN_APPROX_SIMPLE): Suzuki's border
// following, each border's pixels where its direction changes, the borders
// in the tree's pre-order with each node's children last-found first
std::vector<std::vector<P2i>> find_contours_tree_simple(const Img& bin) {
    const int W = bin.cols + 2, H = bin.rows + 2;
    std::vector<int> im((size_t)W * H, 0);
    for (int y = 0; y < bin.rows; y++)
        for (int x = 0; x < bin.cols; x++) im[(size_t)(y + 1) * W + x + 1] = bin.at(y, x) != 0;
    struct Info {
        int parent;
        bool hole;
        std::vector<P2i> pts;
        std::vector<int> children;
    };
    std::vector<Info> info;
    info.push_back({-1, true, {}, {}});  // the frame
    const int deltas8[8] = {1, -W + 1, -W, -W - 1, -1, W - 1, W, W + 1};
    int deltas[16];
    for (int i = 0; i < 16; i++) deltas[i] = deltas8[i & 7];
    const int cdx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
    const int cdy[8] = {0, -1, -1, -1, 0, 1, 1, 1};
    // label of each border: 2 + index in ``info``; negative marks right bounds
    for (int y = 1; y < H - 1; y++) {
        int lnbd = 1;  // the frame
        int prev = 0;
        for (int x = 1; x < W - 1; x++) {
            int p = im[(size_t)y * W + x];
            if (p == prev) {
                continue;
            }
            bool is_outer = prev == 0 && p == 1;
            bool is_hole = !is_outer && p == 0 && prev >= 1;
            if (is_outer || is_hole) {
                int start = is_hole ? x - 1 : x;
                if (is_hole && (prev < 0 || prev > 1)) lnbd = std::abs(prev);
                // parent by Suzuki's rule
                int b = lnbd - 1;  // index in info
                int parent = (info[b].hole == is_hole) ? info[b].parent : b;
                if (parent < 0) parent = 0;
                int idx = (int)info.size();
                const int nbd = idx + 1;
                info.push_back({parent, is_hole, {}, {}});
                info[parent].children.push_back(idx);
                std::vector<P2i>& pts = info[idx].pts;
                // icvFetchContour, CHAIN_APPROX_SIMPLE
                int* base = im.data();
                int i0 = y * W + start, i1, i3, i4 = 0;
                int s, s_end;
                P2i pt(start - 1, y - 1);
                s_end = s = is_hole ? 0 : 4;
                do {
                    s = (s - 1) & 7;
                    i1 = i0 + deltas[s];
                } while (base[i1] == 0 && s != s_end);
                if (s == s_end) {
                    base[i0] = -nbd;
                    pts.push_back(pt);
                } else {
                    i3 = i0;
                    int prev_s = s ^ 4;
                    for (;;) {
                        s_end = s;
                        s = std::min(s, 15);
                        while (s < 15) {
                            i4 = i3 + deltas[++s];
                            if (base[i4] != 0) break;
                        }
                        s &= 7;
                        if ((unsigned)(s - 1) < (unsigned)s_end)
                            base[i3] = -nbd;
                        else if (base[i3] == 1)
                            base[i3] = nbd;
                        if (s != prev_s) {
                            pts.push_back(pt);
                            prev_s = s;
                        }
                        pt.x += cdx[s];
                        pt.y += cdy[s];
                        if (i4 == i0 && i3 == i1) break;
                        i3 = i4;
                        s = (s + 4) & 7;
                    }
                }
                p = im[(size_t)y * W + x];
            }
            if (p != 0 && p != 1) lnbd = std::abs(p);
            prev = p;
        }
    }
    std::vector<std::vector<P2i>> out;
    // pre-order, children last-found first
    std::vector<int> stack;
    for (auto it = info[0].children.rbegin(); it != info[0].children.rend(); ++it) stack.push_back(*it);
    std::reverse(stack.begin(), stack.end());
    while (!stack.empty()) {
        int n = stack.back();
        stack.pop_back();
        out.push_back(info[n].pts);
        // push children so that the last-found comes out first
        for (int c : info[n].children) stack.push_back(c);
    }
    return out;
}

// ------------------------------------------------------------- QRDetect

enum Purpose { ZOOMING = 0, SHRINKING = 1, UNCHANGED = 2 };

struct Vec3d {
    double v[3];
};

// the intersection of lines a1a2 and b1b2, solved as a2 + u·(a1 − a2) =
// b2 + v·(b1 − b2) in float; a2 where they are parallel
P2f intersection_lines(P2f a1, P2f a2, P2f b1, P2f b2) {
    const float divisor = (a1.x - a2.x) * (b1.y - b2.y) - (a1.y - a2.y) * (b1.x - b2.x);
    const float eps = 0.001f;
    if (std::fabs(divisor) < eps) return a2;
    const float u = ((b2.x - a2.x) * (b1.y - b2.y) + (b1.x - b2.x) * (a2.y - b2.y)) / divisor;
    return P2f(a2.x + u * (a1.x - a2.x), a2.y + u * (a1.y - a2.y));
}

// the cosine of the angle abc of integer points: the dot product in int32
// (wrapping), the norms in double
double get_cos_vectors(P2i a, P2i b, P2i c) {
    const int abx = a.x - b.x, aby = a.y - b.y, cbx = c.x - b.x, cby = c.y - b.y;
    const int32_t num = (int32_t)((uint32_t)cby * (uint32_t)aby + (uint32_t)cbx * (uint32_t)abx);
    const double nab = std::sqrt((double)aby * aby + (double)abx * abx);
    const double ncb = std::sqrt((double)cby * cby + (double)cbx * cbx);
    return (double)num / (ncb * nab);
}

bool test_bypass_route(const std::vector<P2f>& hull, int start, int finish) {
    int index_hull = start, next_index_hull, hull_size = (int)hull.size();
    double test_length[2] = {0.0, 0.0};
    do {
        next_index_hull = index_hull + 1;
        if (next_index_hull == hull_size) next_index_hull = 0;
        test_length[0] += norm2f(hull[index_hull] - hull[next_index_hull]);
        index_hull = next_index_hull;
    } while (index_hull != finish);
    index_hull = start;
    do {
        next_index_hull = index_hull - 1;
        if (next_index_hull == -1) next_index_hull = hull_size - 1;
        test_length[1] += norm2f(hull[index_hull] - hull[next_index_hull]);
        index_hull = next_index_hull;
    } while (index_hull != finish);
    return test_length[0] < test_length[1];
}

struct QRDetect {
    Img barcode, bin_barcode, resized_barcode, resized_bin_barcode;
    std::vector<P2f> localization_points, transformation_points;
    double eps_vertical = 0.2, eps_horizontal = 0.1, coeff_expansion = 1.0;
    Purpose purpose = UNCHANGED;

    // ``resized``: the INTER_AREA downscale of ``src`` to the shrunk size,
    // made by the caller (numpy), used when the frame's shorter side > 512
    void init(const Img& src, const Img* resized) {
        barcode = src;
        const double min_side = std::min(src.cols, src.rows);
        if (min_side < 512.0) {
            purpose = ZOOMING;
            coeff_expansion = 512.0 / min_side;
            const int width = cv_round(src.cols * coeff_expansion);
            const int height = cv_round(src.rows * coeff_expansion);
            barcode = resize_linear_exact(src, width, height);
        } else if (min_side > 512.0) {
            purpose = SHRINKING;
            coeff_expansion = min_side / 512.0;
            resized_barcode = *resized;
        } else {
            purpose = UNCHANGED;
            coeff_expansion = 1.0;
        }
        bin_barcode = adaptive_threshold(barcode, 83, 2);
        if (!resized_barcode.empty()) resized_bin_barcode = adaptive_threshold(resized_barcode, 83, 2);
    }

    std::vector<Vec3d> search_horizontal_lines() const {
        std::vector<Vec3d> result;
        const int height = bin_barcode.rows, width = bin_barcode.cols;
        std::vector<size_t> pp;
        for (int y = 0; y < height; y++) {
            pp.clear();
            const uint8_t* row = bin_barcode.row(y);
            int pos = 0;
            for (; pos < width; pos++)
                if (row[pos] == 0) break;
            if (pos == width) continue;
            pp.push_back(pos);
            pp.push_back(pos);
            pp.push_back(pos);
            uint8_t future_pixel = 255;
            for (int x = pos; x < width; x++) {
                if (row[x] == future_pixel) {
                    future_pixel = (uint8_t)~future_pixel;
                    pp.push_back(x);
                }
            }
            pp.push_back(width - 1);
            for (size_t i = 2; i < pp.size() - 3; i += 2) {
                double t[5];
                t[0] = (double)(pp[i - 1] - pp[i - 2]);
                t[1] = (double)(pp[i] - pp[i - 1]);
                t[2] = (double)(pp[i + 1] - pp[i]);
                t[3] = (double)(pp[i + 2] - pp[i + 1]);
                t[4] = (double)(pp[i + 3] - pp[i + 2]);
                double length = 0.0, weight = 0.0;
                for (int j = 0; j < 5; j++) length += t[j];
                if (length == 0) continue;
                for (int j = 0; j < 5; j++) {
                    if (j != 2)
                        weight += std::fabs((t[j] / length) - 1.0 / 7.0);
                    else
                        weight += std::fabs((t[j] / length) - 3.0 / 7.0);
                }
                if (weight < eps_vertical) result.push_back({{(double)pp[i - 2], (double)y, length}});
            }
        }
        return result;
    }

    std::vector<P2f> extract_vertical_lines(const std::vector<Vec3d>& list_lines, double eps) const {
        std::vector<Vec3d> result;
        std::vector<double> test_lines;
        test_lines.reserve(6);
        for (size_t pnt = 0; pnt < list_lines.size(); pnt++) {
            const int x = cv_round(list_lines[pnt].v[0] + list_lines[pnt].v[2] * 0.5);
            const int y = cv_round(list_lines[pnt].v[1]);
            test_lines.clear();
            uint8_t future_pixel_up = 255;
            int temp_length_up = 0;
            for (int j = y; j < bin_barcode.rows - 1; j++) {
                uint8_t next_pixel = bin_barcode.at(j + 1, x);
                temp_length_up++;
                if (next_pixel == future_pixel_up) {
                    future_pixel_up = (uint8_t)~future_pixel_up;
                    test_lines.push_back(temp_length_up);
                    temp_length_up = 0;
                    if (test_lines.size() == 3) break;
                }
            }
            int temp_length_down = 0;
            uint8_t future_pixel_down = 255;
            for (int j = y; j >= 1; j--) {
                uint8_t next_pixel = bin_barcode.at(j - 1, x);
                temp_length_down++;
                if (next_pixel == future_pixel_down) {
                    future_pixel_down = (uint8_t)~future_pixel_down;
                    test_lines.push_back(temp_length_down);
                    temp_length_down = 0;
                    if (test_lines.size() == 6) break;
                }
            }
            if (test_lines.size() == 6) {
                double length = 0.0, weight = 0.0;
                for (size_t i = 0; i < test_lines.size(); i++) length += test_lines[i];
                for (size_t i = 0; i < test_lines.size(); i++) {
                    if (i % 3 != 0)
                        weight += std::fabs((test_lines[i] / length) - 1.0 / 7.0);
                    else
                        weight += std::fabs((test_lines[i] / length) - 3.0 / 14.0);
                }
                if (weight < eps) result.push_back(list_lines[pnt]);
            }
        }
        std::vector<P2f> out;
        if (result.size() > 2) {
            for (size_t i = 0; i < result.size(); i++)
                out.push_back(P2f((float)(result[i].v[0] + result[i].v[2] * 0.5), (float)result[i].v[1]));
        }
        return out;
    }

    std::vector<P2f> separate_vertical_lines(const std::vector<Vec3d>& list_lines) const {
        const double min_dist_between_points = 10.0;
        const double max_ratio = 1.0;
        for (int coeff_epsilon_i = 1; coeff_epsilon_i < 101; ++coeff_epsilon_i) {
            const float coeff_epsilon = coeff_epsilon_i * 0.1f;
            std::vector<P2f> point2f_result = extract_vertical_lines(list_lines, eps_horizontal * coeff_epsilon);
            if (!point2f_result.empty()) {
                std::vector<P2f> centers;
                std::vector<int> labels;
                double compactness = kmeans_pp(point2f_result, 3, 10, 0.1, 3, labels, centers);
                double min_dist = std::numeric_limits<double>::max();
                for (size_t i = 0; i < centers.size(); i++) {
                    double dist = norm2f(centers[i] - centers[(i + 1) % centers.size()]);
                    if (dist < min_dist) min_dist = dist;
                }
                if (min_dist < min_dist_between_points) continue;
                double mean_compactness = compactness / point2f_result.size();
                double ratio = mean_compactness / min_dist;
                if (ratio < max_ratio) return point2f_result;
            }
        }
        return std::vector<P2f>();
    }

    // the arms' third colour change from each vertex, and the largest triangle
    static void fixation_area_index(const Img& bin, const std::vector<P2f>& local_point, size_t& index_max) {
        index_max = 0;
        double max_area = std::numeric_limits<double>::min();
        for (size_t i = 0; i < local_point.size(); i++) {
            const size_t current_index = i % 3;
            const size_t left_index = (i + 1) % 3;
            const size_t right_index = (i + 2) % 3;
            const P2f current_point(local_point[current_index]), left_point(local_point[left_index]),
                right_point(local_point[right_index]);
            const P2f central_point(intersection_lines(
                current_point,
                P2f((float)((local_point[left_index].x + local_point[right_index].x) * 0.5),
                    (float)((local_point[left_index].y + local_point[right_index].y) * 0.5)),
                P2f(0, (float)(bin.rows - 1)), P2f((float)(bin.cols - 1), (float)(bin.rows - 1))));
            std::vector<P2f> list_area_pnt;
            list_area_pnt.push_back(current_point);
            const P2f ends[3] = {left_point, central_point, right_point};
            for (int k = 0; k < 3; k++) {
                std::vector<P2i> li = line_points(bin.cols, bin.rows, to_point(current_point), to_point(ends[k]));
                uint8_t future_pixel = 255, count_index = 0;
                for (size_t j = 0; j < li.size(); j++) {
                    const P2i p = li[j];
                    if (p.x >= bin.cols || p.y >= bin.rows) break;
                    const uint8_t value = bin.at(p.y, p.x);
                    if (value == future_pixel) {
                        future_pixel = (uint8_t)~future_pixel;
                        count_index++;
                        if (count_index == 3) {
                            list_area_pnt.push_back(to_point2f(p));
                            break;
                        }
                    }
                }
            }
            const double temp_check_area = contour_area(list_area_pnt);
            if (temp_check_area > max_area) {
                index_max = current_index;
                max_area = temp_check_area;
            }
        }
    }

    static void fixation_orient(std::vector<P2f>& local_point) {
        const P2f rpt = local_point[0], bpt = local_point[1], gpt = local_point[2];
        // determinant of the Matx22f (rpt - bpt; gpt - rpt), in float
        float a = rpt.x - bpt.x, b = rpt.y - bpt.y, c = gpt.x - rpt.x, d = gpt.y - rpt.y;
        float det = a * d - b * c;
        if (det > 0) std::swap(local_point[1], local_point[2]);
    }

    void fixation_points(std::vector<P2f>& local_point) const {
        double cos_angles[3], norm_triangl[3];
        norm_triangl[0] = norm2f(local_point[1] - local_point[2]);
        norm_triangl[1] = norm2f(local_point[0] - local_point[2]);
        norm_triangl[2] = norm2f(local_point[1] - local_point[0]);
        cos_angles[0] = (norm_triangl[1] * norm_triangl[1] + norm_triangl[2] * norm_triangl[2] -
                         norm_triangl[0] * norm_triangl[0]) / (2 * norm_triangl[1] * norm_triangl[2]);
        cos_angles[1] = (norm_triangl[0] * norm_triangl[0] + norm_triangl[2] * norm_triangl[2] -
                         norm_triangl[1] * norm_triangl[1]) / (2 * norm_triangl[0] * norm_triangl[2]);
        cos_angles[2] = (norm_triangl[0] * norm_triangl[0] + norm_triangl[1] * norm_triangl[1] -
                         norm_triangl[2] * norm_triangl[2]) / (2 * norm_triangl[0] * norm_triangl[1]);
        const double angle_barrier = 0.85;
        if (std::fabs(cos_angles[0]) > angle_barrier || std::fabs(cos_angles[1]) > angle_barrier ||
            std::fabs(cos_angles[2]) > angle_barrier) {
            local_point.clear();
            return;
        }
        size_t i_min_cos = (cos_angles[0] < cos_angles[1] && cos_angles[0] < cos_angles[2])   ? 0
                           : (cos_angles[1] < cos_angles[0] && cos_angles[1] < cos_angles[2]) ? 1
                                                                                              : 2;
        size_t index_max;
        fixation_area_index(bin_barcode, local_point, index_max);
        if (index_max == i_min_cos) {
            std::swap(local_point[0], local_point[index_max]);
        } else {
            local_point.clear();
            return;
        }
        fixation_orient(local_point);
    }

    // no finder found at the first size is not a failure: a frame shrunk
    // to 512 px tries again on its resized binarisation
    bool localization() {
        std::vector<Vec3d> list_lines_x = search_horizontal_lines();
        std::vector<P2f> list_lines_y;
        std::vector<int> labels;
        if (!list_lines_x.empty()) {
            list_lines_y = separate_vertical_lines(list_lines_x);
            if (!list_lines_y.empty()) {
                kmeans_pp(list_lines_y, 3, 10, 0.1, 3, labels, localization_points);
                fixation_points(localization_points);
            }
        }
        bool square_flag = false, local_points_flag = false;
        if (localization_points.size() == 3) {
            double s[3];
            s[0] = norm2f(localization_points[0] - localization_points[1]);
            s[1] = norm2f(localization_points[1] - localization_points[2]);
            s[2] = norm2f(localization_points[2] - localization_points[0]);
            double perim = (s[0] + s[1] + s[2]) * 0.5;
            double square_area = std::sqrt((perim * (perim - s[0]) * (perim - s[1]) * (perim - s[2]))) * 2;
            double img_square_area = (double)(bin_barcode.cols * bin_barcode.rows);
            if (square_area > (img_square_area * 0.2)) square_flag = true;
        } else {
            local_points_flag = true;
        }
        if ((square_flag || local_points_flag) && purpose == SHRINKING) {
            localization_points.clear();
            bin_barcode = resized_bin_barcode;
            list_lines_x = search_horizontal_lines();
            if (list_lines_x.empty()) return false;
            list_lines_y = separate_vertical_lines(list_lines_x);
            if (list_lines_y.empty()) return false;
            kmeans_pp(list_lines_y, 3, 10, 0.1, 3, labels, localization_points);
            fixation_points(localization_points);
            if (localization_points.size() != 3) return false;
            const int width = cv_round(bin_barcode.cols * coeff_expansion);
            const int height = cv_round(bin_barcode.rows * coeff_expansion);
            bin_barcode = resize_linear_exact(bin_barcode, width, height);
            for (auto& p : localization_points) {
                p.x = (float)(p.x * coeff_expansion);
                p.y = (float)(p.y * coeff_expansion);
            }
        }
        if (purpose == ZOOMING) {
            const int width = cv_round(bin_barcode.cols / coeff_expansion);
            const int height = cv_round(bin_barcode.rows / coeff_expansion);
            bin_barcode = resize_linear_exact(bin_barcode, width, height);
            for (auto& p : localization_points) {
                p.x = (float)(p.x / coeff_expansion);
                p.y = (float)(p.y / coeff_expansion);
            }
        }
        for (size_t i = 0; i < localization_points.size(); i++)
            for (size_t j = i + 1; j < localization_points.size(); j++)
                if (norm2f(localization_points[i] - localization_points[j]) < 10) return false;
        return true;
    }

    static std::vector<P2f> get_quadrilateral(const Img& bin_barcode, const std::vector<P2f>& angle_list) {
        const size_t angle_size = angle_list.size();
        Img mask = new_fill_mask(bin_barcode.rows, bin_barcode.cols);
        std::vector<P2i> filled;
        for (size_t i = 0; i < angle_size; i++) {
            std::vector<P2i> li = line_points(bin_barcode.cols, bin_barcode.rows, to_point(angle_list[i % angle_size]),
                                              to_point(angle_list[(i + 1) % angle_size]));
            for (size_t j = 0; j < li.size(); j++) {
                P2i p = li[j];
                uint8_t value = bin_barcode.at(p.y, p.x);
                uint8_t mask_value = mask.at(p.y + 1, p.x + 1);
                if (value == 0 && mask_value == 0) flood_fill_mask(bin_barcode, mask, p, &filled);
            }
        }
        std::vector<P2i> locations = mask_roi_nonzero(filled, bin_barcode.rows, bin_barcode.cols);
        for (size_t i = 0; i < angle_list.size(); i++)
            locations.push_back(P2i(cv_round_f(angle_list[i].x), cv_round_f(angle_list[i].y)));
        std::vector<P2i> integer_hull = convex_hull_i(locations);
        const int hull_size = (int)integer_hull.size();
        std::vector<P2f> hull(hull_size);
        for (int i = 0; i < hull_size; i++) hull[i] = to_point2f(integer_hull[i]);
        const double experimental_area = contour_area(hull);

        // each corner's nearest hull point, a hull point taken at most once
        std::vector<P2f> result_hull_point(angle_size);
        std::vector<bool> hull_used(hull_size, false);
        double min_norm;
        for (size_t i = 0; i < angle_size; i++) {
            min_norm = std::numeric_limits<double>::max();
            int closest = -1;
            for (int j = 0; j < hull_size; j++) {
                if (hull_used[j]) continue;
                double temp_norm = norm2f(hull[j] - angle_list[i]);
                if (min_norm > temp_norm) {
                    min_norm = temp_norm;
                    closest = j;
                }
            }
            if (closest < 0) closest = 0;  // fewer hull points than corners
            result_hull_point[i] = hull[closest];
            hull_used[closest] = true;
        }
        int start_line[2] = {0, 0}, finish_line[2] = {0, 0}, unstable_pnt = 0;
        for (int i = 0; i < hull_size; i++) {
            if (result_hull_point[2] == hull[i]) start_line[0] = i;
            if (result_hull_point[1] == hull[i]) finish_line[0] = start_line[1] = i;
            if (result_hull_point[0] == hull[i]) finish_line[1] = i;
            if (result_hull_point[3] == hull[i]) unstable_pnt = i;
        }
        int index_hull, extra_index_hull, next_index_hull, extra_next_index_hull;
        P2i result_side_begin[4], result_side_end[4];

        bool bypass_orientation = test_bypass_route(hull, start_line[0], finish_line[0]);
        min_norm = std::numeric_limits<double>::max();
        index_hull = start_line[0];
        do {
            next_index_hull = bypass_orientation ? index_hull + 1 : index_hull - 1;
            if (next_index_hull == hull_size) next_index_hull = 0;
            if (next_index_hull == -1) next_index_hull = hull_size - 1;
            P2i angle_closest_pnt = norm2f(hull[index_hull] - angle_list[1]) > norm2f(hull[index_hull] - angle_list[2])
                                        ? to_point(angle_list[2])
                                        : to_point(angle_list[1]);
            P2i intrsc_line_hull = to_point(
                intersection_lines(hull[index_hull], hull[next_index_hull], angle_list[1], angle_list[2]));
            if (intrsc_line_hull == angle_closest_pnt) {  // no angle there
                index_hull = next_index_hull;
                continue;
            }
            double temp_norm = get_cos_vectors(to_point(hull[index_hull]), intrsc_line_hull, angle_closest_pnt);
            if (min_norm > temp_norm &&
                norm2f(hull[index_hull] - hull[next_index_hull]) > norm2f(angle_list[1] - angle_list[2]) * 0.1) {
                min_norm = temp_norm;
                result_side_begin[0] = to_point(hull[index_hull]);
                result_side_end[0] = to_point(hull[next_index_hull]);
            }
            index_hull = next_index_hull;
        } while (index_hull != finish_line[0]);
        if (min_norm == std::numeric_limits<double>::max()) {
            result_side_begin[0] = to_point(angle_list[1]);
            result_side_end[0] = to_point(angle_list[2]);
        }

        min_norm = std::numeric_limits<double>::max();
        index_hull = start_line[1];
        bypass_orientation = test_bypass_route(hull, start_line[1], finish_line[1]);
        do {
            next_index_hull = bypass_orientation ? index_hull + 1 : index_hull - 1;
            if (next_index_hull == hull_size) next_index_hull = 0;
            if (next_index_hull == -1) next_index_hull = hull_size - 1;
            P2i angle_closest_pnt = norm2f(hull[index_hull] - angle_list[0]) > norm2f(hull[index_hull] - angle_list[1])
                                        ? to_point(angle_list[1])
                                        : to_point(angle_list[0]);
            P2i intrsc_line_hull = to_point(
                intersection_lines(hull[index_hull], hull[next_index_hull], angle_list[0], angle_list[1]));
            if (intrsc_line_hull == angle_closest_pnt) {
                index_hull = next_index_hull;
                continue;
            }
            double temp_norm = get_cos_vectors(to_point(hull[index_hull]), intrsc_line_hull, angle_closest_pnt);
            if (min_norm > temp_norm &&
                norm2f(hull[index_hull] - hull[next_index_hull]) > norm2f(angle_list[0] - angle_list[1]) * 0.05) {
                min_norm = temp_norm;
                result_side_begin[1] = to_point(hull[index_hull]);
                result_side_end[1] = to_point(hull[next_index_hull]);
            }
            index_hull = next_index_hull;
        } while (index_hull != finish_line[1]);
        if (min_norm == std::numeric_limits<double>::max()) {
            result_side_begin[1] = to_point(angle_list[0]);
            result_side_end[1] = to_point(angle_list[1]);
        }

        bypass_orientation = test_bypass_route(hull, start_line[0], unstable_pnt);
        const bool extra_bypass_orientation = test_bypass_route(hull, finish_line[1], unstable_pnt);

        std::vector<P2f> result_angle_list(4), test_result_angle_list(4);
        double min_diff_area = std::numeric_limits<double>::max();
        index_hull = start_line[0];
        const double standart_norm =
            std::max(norm2f(to_point2f(result_side_begin[0]) - to_point2f(result_side_end[0])),
                     norm2f(to_point2f(result_side_begin[1]) - to_point2f(result_side_end[1])));
        do {
            next_index_hull = bypass_orientation ? index_hull + 1 : index_hull - 1;
            if (next_index_hull == hull_size) next_index_hull = 0;
            if (next_index_hull == -1) next_index_hull = hull_size - 1;
            if (norm2f(hull[index_hull] - hull[next_index_hull]) < standart_norm * 0.1) {
                index_hull = next_index_hull;
                continue;
            }
            extra_index_hull = finish_line[1];
            do {
                extra_next_index_hull = extra_bypass_orientation ? extra_index_hull + 1 : extra_index_hull - 1;
                if (extra_next_index_hull == hull_size) extra_next_index_hull = 0;
                if (extra_next_index_hull == -1) extra_next_index_hull = hull_size - 1;
                if (norm2f(hull[extra_index_hull] - hull[extra_next_index_hull]) < standart_norm * 0.1) {
                    extra_index_hull = extra_next_index_hull;
                    continue;
                }
                const P2f sb0 = to_point2f(result_side_begin[0]), se0 = to_point2f(result_side_end[0]);
                const P2f sb1 = to_point2f(result_side_begin[1]), se1 = to_point2f(result_side_end[1]);
                test_result_angle_list[0] = intersection_lines(sb0, se0, sb1, se1);
                test_result_angle_list[1] = intersection_lines(sb1, se1, hull[extra_index_hull], hull[extra_next_index_hull]);
                test_result_angle_list[2] = intersection_lines(hull[extra_index_hull], hull[extra_next_index_hull],
                                                               hull[index_hull], hull[next_index_hull]);
                test_result_angle_list[3] = intersection_lines(hull[index_hull], hull[next_index_hull], sb0, se0);
                const double test_diff_area = std::fabs(contour_area(test_result_angle_list) - experimental_area);
                if (min_diff_area > test_diff_area) {
                    min_diff_area = test_diff_area;
                    result_angle_list = test_result_angle_list;
                }
                extra_index_hull = extra_next_index_hull;
            } while (extra_index_hull != unstable_pnt);
            index_hull = next_index_hull;
        } while (index_hull != unstable_pnt);

        if (norm2f(result_angle_list[0] - angle_list[1]) > 2) result_angle_list[0] = angle_list[1];
        if (norm2f(result_angle_list[1] - angle_list[0]) > 2) result_angle_list[1] = angle_list[0];
        if (norm2f(result_angle_list[3] - angle_list[2]) > 2) result_angle_list[3] = angle_list[2];
        if (norm2f(result_angle_list[2] - angle_list[3]) >
            (norm2f(result_angle_list[0] - result_angle_list[1]) + norm2f(result_angle_list[0] - result_angle_list[3])) * 0.5)
            result_angle_list[2] = angle_list[3];
        return result_angle_list;
    }

    // the corners from the three finders' outer rings; with ``in_frame``
    // (``detect``'s, not ``detectMulti``'s) false where a corner rounds beyond
    // the frame
    static bool transformation_points_of(const Img& bin_barcode, const std::vector<P2f>& loc, std::vector<P2f>& out,
                                         bool in_frame) {
        if (loc.size() != 3) return false;
        std::vector<P2i> non_zero_elem[3], newHull;
        std::vector<P2f> new_non_zero_elem[3];
        for (size_t i = 0; i < 3; i++) {
            Img mask = new_fill_mask(bin_barcode.rows, bin_barcode.cols);
            std::vector<P2i> filled;
            uint8_t next_pixel, future_pixel = 255;
            const int ly = cv_round_f(loc[i].y);
            int count_test_lines = 0, index = cv_round_f(loc[i].x);
            for (; index < bin_barcode.cols - 1; index++) {
                next_pixel = bin_barcode.at(ly, index + 1);
                if (next_pixel == future_pixel) {
                    future_pixel = (uint8_t)~future_pixel;
                    count_test_lines++;
                    if (count_test_lines == 2) {
                        flood_fill_mask(bin_barcode, mask, P2i(index + 1, ly), &filled);
                        break;
                    }
                }
            }
            non_zero_elem[i] = mask_roi_nonzero(filled, bin_barcode.rows, bin_barcode.cols);
            newHull.insert(newHull.end(), non_zero_elem[i].begin(), non_zero_elem[i].end());
        }
        std::vector<P2i> locations = convex_hull_i(newHull);
        for (size_t i = 0; i < locations.size(); i++)
            for (size_t j = 0; j < 3; j++)
                for (size_t k = 0; k < non_zero_elem[j].size(); k++)
                    if (locations[i] == non_zero_elem[j][k]) new_non_zero_elem[j].push_back(to_point2f(locations[i]));

        double pentagon_diag_norm = -1;
        P2f down_left_edge_point, up_right_edge_point, up_left_edge_point;
        for (size_t i = 0; i < new_non_zero_elem[1].size(); i++)
            for (size_t j = 0; j < new_non_zero_elem[2].size(); j++) {
                double temp_norm = norm2f(new_non_zero_elem[1][i] - new_non_zero_elem[2][j]);
                if (temp_norm > pentagon_diag_norm) {
                    down_left_edge_point = new_non_zero_elem[1][i];
                    up_right_edge_point = new_non_zero_elem[2][j];
                    pentagon_diag_norm = temp_norm;
                }
            }
        if (down_left_edge_point == P2f(0, 0) || up_right_edge_point == P2f(0, 0) || new_non_zero_elem[0].size() == 0)
            return false;
        double max_area = -1;
        up_left_edge_point = new_non_zero_elem[0][0];
        for (size_t i = 0; i < new_non_zero_elem[0].size(); i++) {
            std::vector<P2f> list_edge_points = {new_non_zero_elem[0][i], down_left_edge_point, up_right_edge_point};
            double temp_area = contour_area(list_edge_points);
            if (max_area < temp_area) {
                up_left_edge_point = new_non_zero_elem[0][i];
                max_area = temp_area;
            }
        }
        P2f down_max_delta_point, up_max_delta_point;
        double norm_down_max_delta = -1, norm_up_max_delta = -1;
        for (size_t i = 0; i < new_non_zero_elem[1].size(); i++) {
            double temp = norm2f(up_left_edge_point - new_non_zero_elem[1][i]) +
                          norm2f(down_left_edge_point - new_non_zero_elem[1][i]);
            if (norm_down_max_delta < temp) {
                down_max_delta_point = new_non_zero_elem[1][i];
                norm_down_max_delta = temp;
            }
        }
        for (size_t i = 0; i < new_non_zero_elem[2].size(); i++) {
            double temp = norm2f(up_left_edge_point - new_non_zero_elem[2][i]) +
                          norm2f(up_right_edge_point - new_non_zero_elem[2][i]);
            if (norm_up_max_delta < temp) {
                up_max_delta_point = new_non_zero_elem[2][i];
                norm_up_max_delta = temp;
            }
        }
        std::vector<P2f> tp = {down_left_edge_point, up_left_edge_point, up_right_edge_point,
                               intersection_lines(down_left_edge_point, down_max_delta_point, up_right_edge_point,
                                                  up_max_delta_point)};
        out = get_quadrilateral(bin_barcode, tp);
        if (!in_frame) return true;
        const int width = bin_barcode.cols, height = bin_barcode.rows;
        for (size_t i = 0; i < out.size(); i++)
            if ((cv_round_f(out[i].x) > width) || (cv_round_f(out[i].y) > height)) return false;
        return true;
    }

    bool compute_transformation_points() {
        return transformation_points_of(bin_barcode, localization_points, transformation_points, true);
    }
};

// ------------------------------------------------------------ QRDetectMulti

struct BWCounter {
    size_t white = 0, black = 0;
    void count1(uint8_t pixel) {
        if (pixel == 255) white++;
        else if (pixel == 0) black++;
    }
    double fraction() const {
        return white == 0 ? std::numeric_limits<double>::infinity() : double(black) / double(white);
    }
    // the outer lines are unclipped, the lines between them clipped to img
    void check_one_pair(P2f tl, P2f tr, P2f bl, P2f br, const Img& img) {
        std::vector<P2i> li1 = line_points(img.cols, img.rows, to_point(tl), to_point(tr), false);
        std::vector<P2i> li2 = line_points(img.cols, img.rows, to_point(bl), to_point(br), false);
        for (size_t i = 0; i < li1.size() && i < li2.size(); i++) {
            std::vector<P2i> it = line_points(img.cols, img.rows, li1[i], li2[i]);
            for (const P2i& p : it) count1(img.at(p.y, p.x));
        }
    }
};

struct QRDetectMulti : QRDetect {
    Img bin_barcode_fullsize, bin_barcode_temp;
    const Img* src_full = nullptr;
    bool have_fullsize = false;
    std::vector<P2f> not_resized_loc_points, resized_loc_points;
    std::vector<std::vector<P2f>> loc_points, trans_points;

    const Img& fullsize() {
        if (!have_fullsize) {
            bin_barcode_fullsize = adaptive_threshold(*src_full, 83, 2);
            have_fullsize = true;
        }
        return bin_barcode_fullsize;
    }

    void init(const Img& src, const Img* resized) {
        src_full = &src;
        const double min_side = std::min(src.cols, src.rows);
        if (min_side < 512.0) {
            purpose = ZOOMING;
            coeff_expansion = 512.0 / min_side;
            barcode = resize_linear_exact(src, cv_round(src.cols * coeff_expansion), cv_round(src.rows * coeff_expansion));
        } else if (min_side > 512.0) {
            purpose = SHRINKING;
            coeff_expansion = min_side * 0.001953125;
            barcode = *resized;
        } else {
            purpose = UNCHANGED;
            coeff_expansion = 1.0;
            barcode = src;
        }
        bin_barcode = adaptive_threshold(barcode, 83, 2);
        if (purpose == UNCHANGED) {
            bin_barcode_fullsize = bin_barcode;
            have_fullsize = true;
        }
    }

    void fixation_points_multi(std::vector<P2f>& local_point) const {
        P2f v0(local_point[1] - local_point[2]);
        P2f v1(local_point[0] - local_point[2]);
        P2f v2(local_point[1] - local_point[0]);
        double cos_angles[3], norm_triangl[3];
        norm_triangl[0] = norm2f(v0);
        norm_triangl[1] = norm2f(v1);
        norm_triangl[2] = norm2f(v2);
        float d0 = v2.x * (-v1.x) + v2.y * (-v1.y);
        float d1 = v2.x * v0.x + v2.y * v0.y;
        float d2 = v1.x * v0.x + v1.y * v0.y;
        cos_angles[0] = d0 / (norm_triangl[1] * norm_triangl[2]);
        cos_angles[1] = d1 / (norm_triangl[0] * norm_triangl[2]);
        cos_angles[2] = d2 / (norm_triangl[0] * norm_triangl[1]);
        const double angle_barrier = 0.85;
        if (std::fabs(cos_angles[0]) > angle_barrier || std::fabs(cos_angles[1]) > angle_barrier ||
            std::fabs(cos_angles[2]) > angle_barrier) {
            local_point.clear();
            return;
        }
        size_t i_min_cos = (cos_angles[0] < cos_angles[1] && cos_angles[0] < cos_angles[2])   ? 0
                           : (cos_angles[1] < cos_angles[0] && cos_angles[1] < cos_angles[2]) ? 1
                                                                                              : 2;
        size_t index_max;
        fixation_area_index(bin_barcode_temp, local_point, index_max);
        if (index_max == i_min_cos) {
            std::swap(local_point[0], local_point[index_max]);
        } else {
            local_point.clear();
            return;
        }
        fixation_orient(local_point);
    }

    // the number of finder centres: lines within 10 px share a centre
    static int count_points(const std::vector<P2f>& ly) {
        std::vector<int> idx(ly.size(), -1);
        int num_points = 0;
        for (size_t i = 0; i + 1 < ly.size(); i++)
            for (size_t j = i; j < ly.size(); j++) {
                double d = norm2f(ly[i] - ly[j]);
                if (d <= 10) {
                    if (idx[i] != -1) idx[j] = idx[i];
                    else if (idx[j] == -1) {
                        idx[i] = idx[j] = num_points;
                        num_points++;
                    } else
                        idx[i] = idx[j];
                }
            }
        for (size_t i = 0; i < idx.size(); i++)
            if (idx[i] == -1) idx[i] = num_points++;
        return num_points;
    }

    int find_number_localization_points(std::vector<P2f>& tmp_localization_points) {
        Img tmp_shrinking = bin_barcode;
        int tmp_num_points = 0;
        double eps = eps_horizontal;
        for (int i = 1; i < 4; i++) {
            eps = i * eps_horizontal;
            size_t npp = purpose == SHRINKING ? 2 : 1;
            tmp_num_points = 0;
            for (size_t k = 0; k < npp; k++) {
                if (k == 1) bin_barcode = fullsize();
                std::vector<Vec3d> list_lines_x = search_horizontal_lines();
                if (list_lines_x.empty()) {
                    if (k == 0) {
                        k = 1;
                        bin_barcode = fullsize();
                        list_lines_x = search_horizontal_lines();
                        if (list_lines_x.empty()) break;
                    } else
                        break;
                }
                std::vector<P2f> list_lines_y = extract_vertical_lines(list_lines_x, eps);
                if (list_lines_y.size() < 3) {
                    if (k == 0) {
                        k = 1;
                        bin_barcode = fullsize();
                        list_lines_x = search_horizontal_lines();
                        if (list_lines_x.empty()) break;
                        list_lines_y = extract_vertical_lines(list_lines_x, eps);
                        if (list_lines_y.size() < 3) break;
                    } else
                        break;
                }
                int num_points = count_points(list_lines_y);
                if (tmp_num_points < num_points && k == 1) {
                    purpose = UNCHANGED;
                    tmp_num_points = num_points;
                    bin_barcode = fullsize();
                    coeff_expansion = 1.0;
                }
                if (tmp_num_points < num_points && k == 0) tmp_num_points = num_points;
            }
            if (tmp_num_points < 3 && tmp_num_points >= 1) {
                const double min_side = std::min(src_full->cols, src_full->rows);
                if (min_side > 512) {
                    bin_barcode = tmp_shrinking;
                    purpose = SHRINKING;
                    coeff_expansion = min_side * 0.001953125;
                }
                if (min_side < 512) {
                    bin_barcode = tmp_shrinking;
                    purpose = ZOOMING;
                    coeff_expansion = 512 / min_side;
                }
            } else
                break;
        }
        if (purpose == SHRINKING) bin_barcode = tmp_shrinking;
        std::vector<Vec3d> list_lines_x = search_horizontal_lines();
        if (list_lines_x.empty()) return tmp_num_points;
        std::vector<P2f> list_lines_y = extract_vertical_lines(list_lines_x, eps);
        if (list_lines_y.size() < 3) return tmp_num_points;
        if (tmp_num_points < 3) return tmp_num_points;
        std::vector<int> labels;
        kmeans_pp(list_lines_y, tmp_num_points, 10, 0.1, tmp_num_points, labels, tmp_localization_points);
        bin_barcode_temp = bin_barcode;
        if (purpose == SHRINKING) {
            bin_barcode = resize_linear_exact(bin_barcode, cv_round(bin_barcode.cols * coeff_expansion),
                                              cv_round(bin_barcode.rows * coeff_expansion));
        } else if (purpose == ZOOMING) {
            bin_barcode = resize_linear_exact(bin_barcode, cv_round(bin_barcode.cols / coeff_expansion),
                                              cv_round(bin_barcode.rows / coeff_expansion));
        } else {
            bin_barcode = fullsize();
        }
        return tmp_num_points;
    }

    void find_qrcode_contours(std::vector<P2f>& tmp_localization_points,
                              std::vector<std::vector<P2f>>& true_points_group, int num_qrcodes) {
        Img bar = resize_linear_exact(barcode, bin_barcode.cols, bin_barcode.rows);
        // blur 3x3 (reflect-101 edges, ushort sums, OpenCV's divide by 9),
        // then threshold at 50
        const int h = bar.rows, w = bar.cols;
        Img thr(h, w);
        auto refl = [](int i, int n) {
            if (n == 1) return 0;
            while (i < 0 || i >= n) i = i < 0 ? -i : 2 * n - 2 - i;
            return i;
        };
        std::vector<int> colsum((size_t)h * w);
        for (int y = 0; y < h; y++)
            for (int x = 0; x < w; x++)
                colsum[(size_t)y * w + x] =
                    bar.at(y, refl(x - 1, w)) + bar.at(y, x) + bar.at(y, refl(x + 1, w));
        for (int y = 0; y < h; y++)
            for (int x = 0; x < w; x++) {
                int s = colsum[(size_t)refl(y - 1, h) * w + x] + colsum[(size_t)y * w + x] +
                        colsum[(size_t)refl(y + 1, h) * w + x];
                int v = (int)(((uint32_t)(s + 4) * 7282u) >> 16);
                thr.at(y, x) = v > 50 ? 255 : 0;
            }
        std::vector<std::vector<P2i>> contours = find_contours_tree_simple(thr);
        std::vector<P2f> all_contours_points;
        for (auto& c : contours)
            for (auto& p : c) all_contours_points.push_back(to_point2f(p));
        int count_contours = num_qrcodes;
        if ((int)all_contours_points.size() < num_qrcodes) count_contours = (int)all_contours_points.size();
        std::vector<int> qrcode_labels;
        std::vector<P2f> clustered;
        if (count_contours > 0)
            kmeans_pp(all_contours_points, count_contours, 10, 0.1, count_contours, qrcode_labels, clustered);
        std::vector<std::vector<P2f>> qrcode_clusters(count_contours);
        for (int i = 0; i < count_contours; i++)
            for (int j = 0; j < (int)all_contours_points.size(); j++)
                if (qrcode_labels[j] == i) qrcode_clusters[i].push_back(all_contours_points[j]);
        std::vector<std::vector<P2f>> hull(count_contours);
        for (size_t i = 0; i < qrcode_clusters.size(); i++) hull[i] = convex_hull_f(qrcode_clusters[i]);
        not_resized_loc_points = tmp_localization_points;
        resized_loc_points = tmp_localization_points;
        if (purpose == SHRINKING) {
            for (auto& p : not_resized_loc_points) {
                p.x = (float)((double)p.x * coeff_expansion);
                p.y = (float)((double)p.y * coeff_expansion);
            }
        } else if (purpose == ZOOMING) {
            for (auto& p : not_resized_loc_points) {
                p.x = (float)((double)p.x / coeff_expansion);
                p.y = (float)((double)p.y / coeff_expansion);
            }
        }
        true_points_group.resize(hull.size());
        for (size_t j = 0; j < hull.size(); j++)
            for (size_t i = 0; i < not_resized_loc_points.size(); i++)
                if (point_polygon_test(hull[j], not_resized_loc_points[i]) > 0) {
                    true_points_group[j].push_back(tmp_localization_points[i]);
                    tmp_localization_points[i].x = -1;
                }
        std::vector<P2f> copy;
        for (size_t j = 0; j < tmp_localization_points.size(); j++)
            if (tmp_localization_points[j].x != -1) copy.push_back(tmp_localization_points[j]);
        tmp_localization_points = copy;
    }

    bool check_points_inside_quadrangle(const std::vector<P2f>& q) const {
        if (q.size() != 4) return false;
        int count = 0;
        for (size_t i = 0; i < not_resized_loc_points.size(); i++)
            if (point_polygon_test(q, not_resized_loc_points[i]) > 0) count++;
        return count == 3;
    }

    bool check_points_inside_triangle(const std::vector<P2f>& t) const {
        if (t.size() != 3) return false;
        const float eps = 3;
        for (size_t i = 0; i < resized_loc_points.size(); i++) {
            if (point_polygon_test(t, resized_loc_points[i]) > 0) {
                if ((std::fabs(resized_loc_points[i].x - t[0].x) > eps) &&
                    (std::fabs(resized_loc_points[i].x - t[1].x) > eps) &&
                    (std::fabs(resized_loc_points[i].x - t[2].x) > eps))
                    return false;
            }
        }
        return true;
    }

    bool check_points(std::vector<P2f> q) const {
        if (q.size() != 4) return false;
        std::sort(q.begin(), q.end(), [](const P2f& a, const P2f& b) { return a.y < b.y || (a.y == b.y && a.x < b.x); });
        BWCounter s;
        s.check_one_pair(q[1], q[0], q[2], q[0], bin_barcode);
        s.check_one_pair(q[1], q[3], q[2], q[3], bin_barcode);
        const double frac = s.fraction();
        return frac > 0.76 && frac < 1.24;
    }

    bool check_sets(std::vector<std::vector<P2f>>& true_points_group, std::vector<std::vector<P2f>>& loc,
                    std::vector<P2f>& tmp_localization_points) {
        for (size_t i = 0; i < true_points_group.size(); i++)
            if (true_points_group[i].size() < 3) {
                for (size_t j = 0; j < true_points_group[i].size(); j++)
                    tmp_localization_points.push_back(true_points_group[i][j]);
                true_points_group[i].clear();
            }
        std::vector<std::vector<P2f>> temp_for_copy;
        for (size_t i = 0; i < true_points_group.size(); i++)
            if (true_points_group[i].size() != 0) temp_for_copy.push_back(true_points_group[i]);
        true_points_group = temp_for_copy;
        if (true_points_group.size() == 0) {
            true_points_group.push_back(tmp_localization_points);
            tmp_localization_points.clear();
        }
        if (true_points_group[0].size() < 3) return false;

        const size_t groups = true_points_group.size();
        std::vector<int> set_size(groups);
        for (size_t i = 0; i < groups; i++) {
            size_t n = true_points_group[i].size();
            set_size[i] = (int)(((n - 2) * (n - 1) * n) / 6);
        }
        struct Vec3i {
            int v[3];
        };
        std::vector<std::vector<Vec3i>> all_points(groups);
        for (size_t i = 0; i < groups; i++) {
            size_t n = true_points_group[i].size();
            all_points[i].resize(set_size[i]);
            int cur = 0;
            for (size_t l = 0; l < n - 2; l++)
                for (size_t j = l + 1; j < n - 1; j++)
                    for (size_t k = j + 1; k < n; k++) all_points[i][cur++] = {{(int)l, (int)j, (int)k}};
        }
        for (size_t i = 0; i < groups; i++) {
            const std::vector<P2f>& pts = true_points_group[i];
            std::sort(all_points[i].begin(), all_points[i].end(), [&pts](const Vec3i& a, const Vec3i& b) {
                P2f a0 = pts[a.v[0]], a1 = pts[a.v[1]], a2 = pts[a.v[2]];
                P2f b0 = pts[b.v[0]], b1 = pts[b.v[1]], b2 = pts[b.v[2]];
                return std::fabs((a1.x - a0.x) * (a2.y - a0.y) - (a2.x - a0.x) * (a1.y - a0.y)) <
                       std::fabs((b1.x - b0.x) * (b2.y - b0.y) - (b2.x - b0.x) * (b1.y - b0.y));
            });
        }
        if (groups == 1) {
            if (set_size[0] > 35) set_size[0] = 35;
            all_points[0].resize(set_size[0]);
        }
        const int iter = (int)loc_points.size();
        loc_points.resize(iter + groups);
        trans_points.resize(iter + groups);
        loc = true_points_group;
        // ParallelSearch: each group's triangles, smallest first
        for (size_t s = 0; s < groups; s++) {
            const size_t x = iter + s;
            for (int k = 0; k < set_size[s]; k++) {
                std::vector<P2f> triangle;
                for (int l = 0; l < 3; l++) triangle.push_back(true_points_group[s][all_points[s][k].v[l]]);
                if (!check_points_inside_triangle(triangle)) continue;
                bool flag_for_break = false;
                bool found = false;
                fixation_points_multi(triangle);
                if (triangle.size() == 3) {
                    loc_points[x] = triangle;
                    if (purpose == SHRINKING) {
                        for (auto& p : loc_points[x]) {
                            p.x = (float)((double)p.x * coeff_expansion);
                            p.y = (float)((double)p.y * coeff_expansion);
                        }
                    } else if (purpose == ZOOMING) {
                        for (auto& p : loc_points[x]) {
                            p.x = (float)((double)p.x / coeff_expansion);
                            p.y = (float)((double)p.y / coeff_expansion);
                        }
                    }
                    for (size_t i = 0; i < 3 && !flag_for_break; i++)
                        for (size_t j = i + 1; j < 3; j++)
                            if (norm2f(loc_points[x][i] - loc_points[x][j]) < 10) {
                                loc_points[x].clear();
                                flag_for_break = true;
                                break;
                            }
                    if (!flag_for_break && loc_points[x].size() == 3 &&
                        transformation_points_of(bin_barcode, loc_points[x], trans_points[x], false) &&
                        check_points_inside_quadrangle(trans_points[x]) && check_points(trans_points[x])) {
                        for (int l = 0; l < 3; l++) loc[s][all_points[s][k].v[l]].x = -1;
                        found = true;
                    }
                }
                if (found) break;
                trans_points[x].clear();
                loc_points[x].clear();
            }
        }
        return true;
    }

    void delete_used_points(std::vector<std::vector<P2f>>& true_points_group, std::vector<std::vector<P2f>>& loc,
                            std::vector<P2f>& tmp_localization_points) {
        size_t iter = loc_points.size() - true_points_group.size();
        for (size_t s = 0; s < true_points_group.size(); s++) {
            if (loc_points[iter + s].empty()) loc[s][0].x = -2;
            if (loc[s].size() == 3) {
                if ((true_points_group.size() > 1) ||
                    ((true_points_group.size() == 1) && (tmp_localization_points.size() != 0))) {
                    for (size_t j = 0; j < true_points_group[s].size(); j++)
                        if (loc[s][j].x != -1) {
                            loc[s][j].x = -1;
                            tmp_localization_points.push_back(true_points_group[s][j]);
                        }
                }
            }
            std::vector<P2f> for_tmp;
            for (size_t j = 0; j < loc[s].size(); j++) {
                if ((loc[s][j].x != -1) && (loc[s][j].x != -2)) for_tmp.push_back(true_points_group[s][j]);
                if ((loc[s][j].x == -2) && (true_points_group.size() > 1))
                    tmp_localization_points.push_back(true_points_group[s][j]);
            }
            true_points_group[s] = for_tmp;
        }
        std::vector<std::vector<P2f>> keep_loc, keep_trans;
        for (size_t i = 0; i < loc_points.size(); i++)
            if (loc_points[i].size() == 3 && trans_points[i].size() == 4) {
                keep_loc.push_back(loc_points[i]);
                keep_trans.push_back(trans_points[i]);
            }
        loc_points = keep_loc;
        trans_points = keep_trans;
    }

    bool localization() {
        std::vector<P2f> tmp_localization_points;
        int num_points = find_number_localization_points(tmp_localization_points);
        if (num_points < 3) return false;
        int num_qrcodes = (num_points + 2) / 3;
        std::vector<std::vector<P2f>> true_points_group;
        find_qrcode_contours(tmp_localization_points, true_points_group, num_qrcodes);
        for (int q = 0; q < num_qrcodes; q++) {
            std::vector<std::vector<P2f>> loc;
            size_t iter = loc_points.size();
            if (!check_sets(true_points_group, loc, tmp_localization_points)) break;
            delete_used_points(true_points_group, loc, tmp_localization_points);
            if ((loc_points.size() - iter) == 1) q--;
            if (((loc_points.size() - iter) == 0) && (tmp_localization_points.size() == 0) &&
                (true_points_group.size() == 1))
                break;
        }
        if (trans_points.size() == 0 || loc_points.size() == 0) return false;
        return true;
    }
};

Img wrap(const uint8_t* p, int rows, int cols) {
    Img m(rows, cols);
    std::memcpy(m.d.data(), p, (size_t)rows * cols);
    return m;
}

}  // namespace

extern "C" {

void qr_set_rng_state(uint64_t state) { rng_state = state; }
uint64_t qr_rng_state() { return rng_state; }
uint32_t qr_rng_next() { return rng_next(); }

// cv::kmeans(pts, K, labels, (EPS + COUNT, max_count, epsilon), attempts,
// KMEANS_PP_CENTERS, centers) on the calling thread's generator
double qr_kmeans(const float* pts, int64_t n, int k, int max_count, double epsilon, int attempts, int32_t* labels,
                 float* centers) {
    std::vector<P2f> data(n);
    for (int64_t i = 0; i < n; i++) data[i] = P2f(pts[2 * i], pts[2 * i + 1]);
    std::vector<int> lab;
    std::vector<P2f> cen;
    double c = kmeans_pp(data, k, max_count, epsilon, attempts, lab, cen);
    for (int64_t i = 0; i < n; i++) labels[i] = lab[i];
    for (int i = 0; i < k; i++) {
        centers[2 * i] = cen[i].x;
        centers[2 * i + 1] = cen[i].y;
    }
    return c;
}

void qr_gaussian_replicate(const uint8_t* src, int rows, int cols, int ksize, float* out) {
    std::vector<float> o;
    gaussian_blur_replicate_f32(wrap(src, rows, cols), ksize, o);
    std::memcpy(out, o.data(), o.size() * sizeof(float));
}

void qr_adaptive_threshold(const uint8_t* src, int rows, int cols, int block, double c, uint8_t* out) {
    Img r = adaptive_threshold(wrap(src, rows, cols), block, c);
    std::memcpy(out, r.d.data(), r.d.size());
}

void qr_resize_linear_exact(const uint8_t* src, int rows, int cols, int dw, int dh, uint8_t* out) {
    Img r = resize_linear_exact(wrap(src, rows, cols), dw, dh);
    std::memcpy(out, r.d.data(), r.d.size());
}

// floodFill(img, mask, seed, 255, 0, Scalar(), Scalar(), FLOODFILL_MASK_ONLY)
// on a (rows + 2) x (cols + 2) mask that the call updates
void qr_flood_fill(const uint8_t* src, int rows, int cols, uint8_t* mask, int sx, int sy) {
    Img img = wrap(src, rows, cols);
    Img m = wrap(mask, rows + 2, cols + 2);
    for (int x = 0; x < cols + 2; x++) m.at(0, x) = m.at(rows + 1, x) = 1;
    for (int y = 0; y < rows + 2; y++) m.at(y, 0) = m.at(y, cols + 1) = 1;
    flood_fill_mask(img, m, P2i(sx, sy));
    std::memcpy(mask, m.d.data(), m.d.size());
}

// convexHull of int (is_float 0) or float points → the hull's indices
int64_t qr_convex_hull(const void* pts, int64_t n, int is_float, int32_t* out_idx) {
    std::vector<int> idx;
    if (is_float) {
        const float* f = (const float*)pts;
        std::vector<P2f> p(n);
        for (int64_t i = 0; i < n; i++) p[i] = P2f(f[2 * i], f[2 * i + 1]);
        idx = convex_hull_idx<P2f, double>(p);
    } else {
        const int32_t* f = (const int32_t*)pts;
        std::vector<P2i> p(n);
        for (int64_t i = 0; i < n; i++) p[i] = P2i(f[2 * i], f[2 * i + 1]);
        idx = convex_hull_idx<P2i, int64_t>(p);
    }
    for (size_t i = 0; i < idx.size(); i++) out_idx[i] = idx[i];
    return (int64_t)idx.size();
}

// findContours(img != 0, RETR_TREE, CHAIN_APPROX_SIMPLE): writes each
// contour's point count to ``counts`` and the points to ``pts`` (both
// sized by the caller for ``cap`` values); → the number of contours, or
// -1 where the buffers are too small
int64_t qr_find_contours(const uint8_t* src, int rows, int cols, int32_t* counts, int32_t* pts, int64_t cap) {
    std::vector<std::vector<P2i>> cs = find_contours_tree_simple(wrap(src, rows, cols));
    int64_t total = 0;
    for (auto& c : cs) total += (int64_t)c.size();
    if ((int64_t)cs.size() > cap || total > cap) return -1;
    int64_t o = 0;
    for (size_t i = 0; i < cs.size(); i++) {
        counts[i] = (int32_t)cs[i].size();
        for (auto& p : cs[i]) {
            pts[2 * o] = p.x;
            pts[2 * o + 1] = p.y;
            o++;
        }
    }
    return (int64_t)cs.size();
}

// cv2.QRCodeDetector().detectMulti(gray): → the number of codes (0 where
// it fails), their quads in ``quads`` (8 floats a code, at most
// ``max_codes``). ``resized``: the INTER_AREA downscale to the shrunk size
// where the shorter side exceeds 512, else null.
int qr_detect_multi(const uint8_t* gray, int rows, int cols, const uint8_t* resized, int rrows, int rcols,
                    float* quads, int max_codes) {
    if (cols <= 20 || rows <= 20) return 0;
    Img src = wrap(gray, rows, cols);
    Img small;
    if (resized) small = wrap(resized, rrows, rcols);
    QRDetectMulti det;
    det.init(src, resized ? &small : nullptr);
    if (!det.localization()) return 0;
    int n = 0;
    for (size_t i = 0; i < det.trans_points.size() && n < max_codes; i++, n++)
        for (int j = 0; j < 4; j++) {
            quads[8 * n + 2 * j] = det.trans_points[i][j].x;
            quads[8 * n + 2 * j + 1] = det.trans_points[i][j].y;
        }
    return n;
}

// cv2.QRCodeDetector().detect(gray): → 1 and the quad in ``quad``, or 0
int qr_detect(const uint8_t* gray, int rows, int cols, const uint8_t* resized, int rrows, int rcols, float* quad) {
    if (cols <= 20 || rows <= 20) return 0;
    Img src = wrap(gray, rows, cols);
    Img small;
    if (resized) small = wrap(resized, rrows, rcols);
    QRDetect det;
    det.init(src, resized ? &small : nullptr);
    if (!det.localization()) return 0;
    if (!det.compute_transformation_points()) return 0;
    for (int j = 0; j < 4; j++) {
        quad[2 * j] = det.transformation_points[j].x;
        quad[2 * j + 1] = det.transformation_points[j].y;
    }
    return 1;
}

}  // extern "C"
