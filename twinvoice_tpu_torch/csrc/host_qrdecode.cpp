// The QR decoder of OpenCV's ``cv2.QRCodeDetector`` (objdetect's QRDecode and
// QRCodeDecoderImpl, as OpenCV 5.0 builds them), rebuilt step by step in
// plain C++ for the port's QR scan. It is compiled as one library with the
// locator (``host_qrlocate.cpp``, included below), so ``detectAndDecode``
// and ``detectAndDecodeMulti`` draw k-means++ seeds from the locator's
// per-thread generator, as cv2's ``theRNG()`` is drawn from.
//
// The stages, from a quad of the frame to the payload:
//
// - ``init``: adaptiveThreshold (Gaussian, 83, 2) of the frame; the side of
//   the square the code is warped to is max(251, shortest quad side + 1);
// - ``updatePerspective``: the homography of the quad onto that square
//   (findHomography of the 4 points: the normalised DLT, Jacobi
//   eigenvectors), warpPerspective (INTER_NEAREST, border 0) of the binary
//   frame, its first row and column cut, and a white border of a tenth of
//   the side added;
// - ``versionDefinition``: the version from the transitions along a row and
//   a column of the warped code, from the size of the three finder patterns
//   in the binary frame (flood fills from the quad's corners, the four
//   sharpest corners of each pattern's hull), and for versions 7 and up
//   from the version information blocks (Hamming distance plus 0.8 a
//   version of distance from the estimate, kept where below 5);
// - ``detectAlignment``: the alignment patterns near the bottom-right
//   corner (and for versions 7 and up the ones next to the finders),
//   located by matchTemplate (TM_CCOEFF_NORMED) of a 5-module pattern in
//   8.8-module windows, kept where the score exceeds 0.65, and the
//   homography refitted on them (RANSAC, threshold 5 at version 2, else 10);
// - ``samplingForVersion``: the warped code enlarged 1, 2 or 3 times
//   (INTER_AREA), cut into module tiles, each tile dark where its share of
//   light pixels is below the whole code's;
// - ``QRCodeDecoderImpl``: format information (both copies), the data mask,
//   the codewords, Reed-Solomon correction per block (Berlekamp-Massey and
//   Forney), the segments; the transposed grid (a mirrored code) where the
//   first pass fails;
// - ``decodingProcess``: the payload as OpenCV hands it on: numeric and
//   alphanumeric must be ASCII, bytes with the UTF-8 ECI must be UTF-8,
//   UTF-16BE is refused, other bytes are kept where they are ASCII or valid
//   UTF-8 and otherwise read as ISO-8859-1 and re-encoded in UTF-8.
//
// Each OpenCV primitive is rebuilt as that build computes it (float types,
// operation order, rounding); where OpenCV's dispatched (AVX2/AVX-512) code
// fuses a multiply-add, the same one is fused here with std::fma. Three are
// followed to their values, not their last bits: the homography (OpenCV 5's
// vectorised DLT; the float32 inverse the warp uses comes out the same),
// the RANSAC refit's Levenberg-Marquardt (5.0's LevMarq solves through
// LAPACK) and matchTemplate (its cross-correlation is Intel IPP's FFT; here
// it is summed exactly).

#include "host_qrlocate.cpp"

#include <array>
#include <string>

namespace {

using M33 = std::array<double, 9>;

// ------------------------------------------------------------ small algebra

// cv::Jacobi (lapack.cpp) on a symmetric double n x n matrix: eigenvalues in
// W (descending) and eigenvectors in the rows of V
void jacobi_eigen(double* A, int n, double* W, double* V) {
    const double eps = std::numeric_limits<double>::epsilon();
    for (int i = 0; i < n; i++) {
        for (int j = 0; j < n; j++) V[i * n + j] = 0.;
        V[i * n + i] = 1.;
    }
    std::vector<int> indR(n, 0), indC(n, 0);
    int k, m, i;
    double mv;
    for (k = 0; k < n; k++) {
        W[k] = A[(n + 1) * k];
        if (k < n - 1) {
            for (m = k + 1, mv = std::fabs(A[n * k + m]), i = k + 2; i < n; i++) {
                double val = std::fabs(A[n * k + i]);
                if (mv < val) mv = val, m = i;
            }
            indR[k] = m;
        }
        if (k > 0) {
            for (m = 0, mv = std::fabs(A[k]), i = 1; i < k; i++) {
                double val = std::fabs(A[n * i + k]);
                if (mv < val) mv = val, m = i;
            }
            indC[k] = m;
        }
    }
    if (n > 1)
        for (int iters = 0, maxIters = n * n * 30; iters < maxIters; iters++) {
            for (k = 0, mv = std::fabs(A[indR[0]]), i = 1; i < n - 1; i++) {
                double val = std::fabs(A[n * i + indR[i]]);
                if (mv < val) mv = val, k = i;
            }
            int l = indR[k];
            for (i = 1; i < n; i++) {
                double val = std::fabs(A[n * indC[i] + i]);
                if (mv < val) mv = val, k = indC[i], l = i;
            }
            double p = A[n * k + l];
            if (std::fabs(p) <= eps) break;
            double y = (W[l] - W[k]) * 0.5;
            double t = std::fabs(y) + std::hypot(p, y);
            double s = std::hypot(p, t);
            double c = t / s;
            s = p / s;
            t = (p / t) * p;
            if (y < 0) s = -s, t = -t;
            A[n * k + l] = 0;
            W[k] -= t;
            W[l] += t;
            double a0, b0;
            auto rot = [&](double& v0, double& v1) {
                a0 = v0, b0 = v1;
                v0 = a0 * c - b0 * s;
                v1 = a0 * s + b0 * c;
            };
            for (i = 0; i < k; i++) rot(A[n * i + k], A[n * i + l]);
            for (i = k + 1; i < l; i++) rot(A[n * k + i], A[n * i + l]);
            for (i = l + 1; i < n; i++) rot(A[n * k + i], A[n * l + i]);
            for (i = 0; i < n; i++) rot(V[n * k + i], V[n * l + i]);
            for (int j = 0; j < 2; j++) {
                int idx = j == 0 ? k : l;
                if (idx < n - 1) {
                    for (m = idx + 1, mv = std::fabs(A[n * idx + m]), i = idx + 2; i < n; i++) {
                        double val = std::fabs(A[n * idx + i]);
                        if (mv < val) mv = val, m = i;
                    }
                    indR[idx] = m;
                }
                if (idx > 0) {
                    for (m = 0, mv = std::fabs(A[idx]), i = 1; i < idx; i++) {
                        double val = std::fabs(A[n * i + idx]);
                        if (mv < val) mv = val, m = i;
                    }
                    indC[idx] = m;
                }
            }
        }
    for (k = 0; k < n - 1; k++) {
        m = k;
        for (i = k + 1; i < n; i++)
            if (W[m] < W[i]) m = i;
        if (k != m) {
            std::swap(W[m], W[k]);
            for (i = 0; i < n; i++) std::swap(V[n * m + i], V[n * k + i]);
        }
    }
}

// 3x3 product, each entry a[0]b[0] + a[1]b[3] + a[2]b[6] with the last two
// products fused
M33 mul33(const M33& a, const M33& b) {
    M33 d;
    for (int i = 0; i < 3; i++)
        for (int j = 0; j < 3; j++)
            d[3 * i + j] = std::fma(a[3 * i + 2], b[6 + j], std::fma(a[3 * i + 1], b[3 + j], a[3 * i] * b[j]));
    return d;
}

// cv::invert(m, DECOMP_LU) of a 3x3 double matrix (the closed form); false
// where the determinant is 0
bool invert33(const M33& m, M33& out) {
    auto M = [&](int r, int c) { return m[3 * r + c]; };
    double d = M(0, 0) * (M(1, 1) * M(2, 2) - M(1, 2) * M(2, 1)) - M(0, 1) * (M(1, 0) * M(2, 2) - M(1, 2) * M(2, 0)) +
               M(0, 2) * (M(1, 0) * M(2, 1) - M(1, 1) * M(2, 0));
    if (d == 0.) return false;
    d = 1. / d;
    out = {(M(1, 1) * M(2, 2) - M(1, 2) * M(2, 1)) * d, (M(0, 2) * M(2, 1) - M(0, 1) * M(2, 2)) * d,
           (M(0, 1) * M(1, 2) - M(0, 2) * M(1, 1)) * d, (M(1, 2) * M(2, 0) - M(1, 0) * M(2, 2)) * d,
           (M(0, 0) * M(2, 2) - M(0, 2) * M(2, 0)) * d, (M(0, 2) * M(1, 0) - M(0, 0) * M(1, 2)) * d,
           (M(1, 0) * M(2, 1) - M(1, 1) * M(2, 0)) * d, (M(0, 1) * M(2, 0) - M(0, 0) * M(2, 1)) * d,
           (M(0, 0) * M(1, 1) - M(0, 1) * M(1, 0)) * d};
    return true;
}

// cv::perspectiveTransform of float points by a double 3x3 matrix, as its
// dispatched loop computes it (the first two products of each row fused)
void perspective_transform(std::vector<P2f>& pts, const M33& m) {
    const double eps = FLT_EPSILON;
    for (P2f& p : pts) {
        double x = p.x, y = p.y;
        double w = std::fma(y, m[7], x * m[6]) + m[8];
        if (std::fabs(w) > eps) {
            w = 1. / w;
            p = P2f((float)((std::fma(y, m[1], x * m[0]) + m[2]) * w), (float)((std::fma(y, m[4], x * m[3]) + m[5]) * w));
        } else {
            p = P2f(0.f, 0.f);
        }
    }
}

// ------------------------------------------------------------- homography

// HomographyEstimatorCallback::runKernel as OpenCV 5 builds it: the DLT on
// isotropically normalised points (each set moved to its centroid and
// scaled to a mean distance of sqrt(2)), the eigenvector of the smallest
// eigenvalue of the 9x9 normal matrix (Jacobi), denormalised and scaled to
// H[2][2] = 1; false where a set is degenerate. OpenCV's own arithmetic
// differs in the last bits (its normal matrix and denormalisation are
// vectorised otherwise), which leaves the float32 inverse the warp uses
// unchanged.
bool homography_kernel(const std::vector<P2f>& M, const std::vector<P2f>& m, M33& H) {
    const int count = (int)M.size();
    const double inv = 1. / count;
    double cMx = 0, cMy = 0, cmx = 0, cmy = 0;
    for (int i = 0; i < count; i++) {
        cMx += M[i].x, cMy += M[i].y;
        cmx += m[i].x, cmy += m[i].y;
    }
    cMx *= inv, cMy *= inv, cmx *= inv, cmy *= inv;
    double dM = 0, dm = 0;
    for (int i = 0; i < count; i++) {
        dM += std::sqrt((M[i].x - cMx) * (M[i].x - cMx) + (M[i].y - cMy) * (M[i].y - cMy));
        dm += std::sqrt((m[i].x - cmx) * (m[i].x - cmx) + (m[i].y - cmy) * (m[i].y - cmy));
    }
    dM *= inv, dm *= inv;
    if (FLT_EPSILON > dM || FLT_EPSILON > dm) return false;
    const double sM = 1.4142135623730951 / dM, sm = 1.4142135623730951 / dm;
    double LtL[81] = {0};
    for (int i = 0; i < count; i++) {
        double X = (M[i].x - cMx) * sM, Y = (M[i].y - cMy) * sM;
        double x = (m[i].x - cmx) * sm, y = (m[i].y - cmy) * sm;
        double Lx[] = {X, Y, 1, 0, 0, 0, -x * X, -x * Y, -x};
        double Ly[] = {0, 0, 0, X, Y, 1, -y * X, -y * Y, -y};
        for (int j = 0; j < 9; j++)
            for (int k = 0; k < 9; k++) LtL[j * 9 + k] += Lx[j] * Lx[k] + Ly[j] * Ly[k];
    }
    double W[9], V[81];
    jacobi_eigen(LtL, 9, W, V);
    for (int i = 0; i < 8; i++)
        if (DBL_EPSILON > std::fabs(W[i])) return false;
    M33 H0;
    for (int i = 0; i < 9; i++) H0[i] = V[72 + i];
    // H = Tm^-1 · H0 · TM
    M33 invTm = {1. / sm, 0, cmx, 0, 1. / sm, cmy, 0, 0, 1};
    M33 TM = {sM, 0, -cMx * sM, 0, sM, -cMy * sM, 0, 0, 1};
    M33 Ht = mul33(invTm, H0);
    H0 = mul33(Ht, TM);
    double s = 1. / H0[8];
    for (int i = 0; i < 9; i++) H[i] = H0[i] * s;
    return true;
}

// cv::RNG as a value (RANSAC's own RNG((uint64)-1), not theRNG())
struct Rng {
    uint64_t s;
    unsigned next() {
        s = (uint64_t)(unsigned)s * 4164903690ULL + (unsigned)(s >> 32);
        return (unsigned)s;
    }
    int uniform(int a, int b) { return a == b ? a : (int)(next() % (unsigned)(b - a) + a); }
};

bool have_collinear_points(const P2f* p, int count) {
    int i = count - 1;
    for (int j = 0; j < i; j++) {
        double dx1 = p[j].x - p[i].x, dy1 = p[j].y - p[i].y;
        for (int k = 0; k < j; k++) {
            double dx2 = p[k].x - p[i].x, dy2 = p[k].y - p[i].y;
            if (std::fabs(dx2 * dy1 - dy2 * dx1) <= FLT_EPSILON * (std::fabs(dx1) + std::fabs(dy1) + std::fabs(dx2) + std::fabs(dy2)))
                return true;
        }
    }
    return false;
}

double det33(double a, double b, double c, double d, double e, double f, double g, double h, double i) {
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
}

// HomographyEstimatorCallback::checkSubset
bool homography_subset_ok(const P2f* s, const P2f* d, int count) {
    if (have_collinear_points(s, count) || have_collinear_points(d, count)) return false;
    if (count == 4) {
        static const int tt[4][3] = {{0, 1, 2}, {1, 2, 3}, {0, 2, 3}, {0, 1, 3}};
        int negative = 0;
        for (int i = 0; i < 4; i++) {
            const int* t = tt[i];
            double a = det33(s[t[0]].x, s[t[0]].y, 1., s[t[1]].x, s[t[1]].y, 1., s[t[2]].x, s[t[2]].y, 1.);
            double b = det33(d[t[0]].x, d[t[0]].y, 1., d[t[1]].x, d[t[1]].y, 1., d[t[2]].x, d[t[2]].y, 1.);
            negative += a * b < 0;
        }
        if (negative != 0 && negative != 4) return false;
    }
    return true;
}

// HomographyEstimatorCallback::computeError, against the squared threshold
int homography_inliers(const std::vector<P2f>& M, const std::vector<P2f>& m, const M33& H, double thresh,
                       std::vector<uint8_t>& mask) {
    float Hf[8];
    for (int i = 0; i < 8; i++) Hf[i] = (float)H[i];
    const float t = (float)(thresh * thresh);
    int nz = 0;
    mask.assign(M.size(), 0);
    for (size_t i = 0; i < M.size(); i++) {
        float ww = 1.f / (Hf[6] * M[i].x + Hf[7] * M[i].y + 1.f);
        float dx = (Hf[0] * M[i].x + Hf[1] * M[i].y + Hf[2]) * ww - m[i].x;
        float dy = (Hf[3] * M[i].x + Hf[4] * M[i].y + Hf[5]) * ww - m[i].y;
        float err = dx * dx + dy * dy;
        mask[i] = err <= t;
        nz += mask[i];
    }
    return nz;
}

int ransac_update_num_iters(double p, double ep, int model_points, int max_iters) {
    p = std::min(std::max(p, 0.), 1.);
    ep = std::min(std::max(ep, 0.), 1.);
    double num = std::max(1. - p, DBL_MIN);
    double denom = 1. - std::pow(1. - ep, model_points);
    if (denom < DBL_MIN) return 0;
    num = std::log(num);
    denom = std::log(denom);
    return denom >= 0 || -num >= max_iters * (-denom) ? max_iters : cv_round(num / denom);
}

// solve A x = b for a small dense system (Gaussian elimination, partial
// pivoting); false where A is singular
bool solve_dense(std::vector<double> A, std::vector<double> b, int n, std::vector<double>& x) {
    for (int c = 0; c < n; c++) {
        int p = c;
        for (int r = c + 1; r < n; r++)
            if (std::fabs(A[r * n + c]) > std::fabs(A[p * n + c])) p = r;
        if (A[p * n + c] == 0.) return false;
        if (p != c) {
            for (int k = 0; k < n; k++) std::swap(A[p * n + k], A[c * n + k]);
            std::swap(b[p], b[c]);
        }
        for (int r = c + 1; r < n; r++) {
            double f = A[r * n + c] / A[c * n + c];
            for (int k = c; k < n; k++) A[r * n + k] -= f * A[c * n + k];
            b[r] -= f * b[c];
        }
    }
    x.assign(n, 0.);
    for (int r = n - 1; r >= 0; r--) {
        double s = b[r];
        for (int k = r + 1; k < n; k++) s -= A[r * n + k] * x[k];
        x[r] = s / A[r * n + r];
    }
    return true;
}

// HomographyRefineCallback: the reprojection residuals of the 8 free
// entries (the ninth held at 1) and, where ``J`` is given, their Jacobian
void homography_residuals(const std::vector<P2f>& M, const std::vector<P2f>& m, const double* h,
                          std::vector<double>& err, std::vector<double>* J) {
    const size_t n = M.size();
    err.assign(2 * n, 0.);
    if (J) J->assign(16 * n, 0.);
    for (size_t i = 0; i < n; i++) {
        double Mx = M[i].x, My = M[i].y;
        double ww = h[6] * Mx + h[7] * My + 1.;
        ww = std::fabs(ww) > DBL_EPSILON ? 1. / ww : 0;
        double xi = (h[0] * Mx + h[1] * My + h[2]) * ww;
        double yi = (h[3] * Mx + h[4] * My + h[5]) * ww;
        err[2 * i] = xi - m[i].x;
        err[2 * i + 1] = yi - m[i].y;
        if (J) {
            double* j = J->data() + 16 * i;
            j[0] = Mx * ww, j[1] = My * ww, j[2] = ww;
            j[6] = -Mx * ww * xi, j[7] = -My * ww * xi;
            j[11] = Mx * ww, j[12] = My * ww, j[13] = ww;
            j[14] = -Mx * ww * yi, j[15] = -My * ww * yi;
        }
    }
}

// the Levenberg-Marquardt refinement findHomography runs on the inliers:
// cv::LMSolver's schedule (lambda from 1e-3, 10 accepted steps at most,
// stopping where a step or the error falls below FLT_EPSILON). Its linear
// solves are OpenCV's SVD through LAPACK, so the last bits of the refined
// matrix can differ; the refinement converges to the same minimum.
void homography_refine(const std::vector<P2f>& M, const std::vector<P2f>& m, M33& H) {
    const int lx = 8;
    std::vector<double> x(H.begin(), H.begin() + 8), r, J, xd(8), rd;
    homography_residuals(M, m, x.data(), r, &J);
    const size_t rows = r.size();
    auto normal = [&](std::vector<double>& A, std::vector<double>& v) {
        A.assign(lx * lx, 0.);
        v.assign(lx, 0.);
        for (size_t k = 0; k < rows; k++)
            for (int a = 0; a < lx; a++) {
                v[a] += J[k * lx + a] * r[k];
                for (int b = 0; b < lx; b++) A[a * lx + b] += J[k * lx + a] * J[k * lx + b];
            }
    };
    auto sq = [](const std::vector<double>& e) {
        double s = 0;
        for (double v : e) s += v * v;
        return s;
    };
    double S = sq(r);
    std::vector<double> A, v, d;
    normal(A, v);
    int lambda_lg10 = -3, iter = 0;
    const double eps = FLT_EPSILON;
    for (;;) {
        std::vector<double> Ap = A;
        const double lambda = std::exp(lambda_lg10 * std::log(10.));
        for (int i = 0; i < lx; i++) Ap[i * lx + i] *= 1 + lambda;
        if (!solve_dense(Ap, v, lx, d)) break;
        for (int i = 0; i < lx; i++) xd[i] = x[i] - d[i];
        homography_residuals(M, m, xd.data(), rd, nullptr);
        const double Sd = sq(rd);
        if (Sd < S) {
            S = Sd;
            lambda_lg10 = std::max(lambda_lg10 - 1, -16);
            iter++;
            std::swap(x, xd);
            homography_residuals(M, m, x.data(), r, &J);
            normal(A, v);
        } else {
            iter += lambda_lg10 == 16;
            lambda_lg10 = std::min(lambda_lg10 + 1, 16);
        }
        double dmax = 0;
        for (double e : d) dmax = std::max(dmax, std::fabs(e));
        if (!(iter < 10 && dmax >= eps && S >= eps * eps)) break;
    }
    for (int i = 0; i < 8; i++) H[i] = x[i];
}

// cv::findHomography(src, dst, RANSAC, thresh, noArray(), 2000, 0.995);
// false where it finds none (an empty matrix)
bool find_homography_ransac(std::vector<P2f> src, std::vector<P2f> dst, double thresh, M33& H) {
    const int count = (int)src.size();
    const int model_points = 4;
    if (count == 4) return homography_kernel(src, dst, H);
    if (count < model_points) return false;
    Rng rng{~(uint64_t)0};
    int niters = 2000, max_good = 0;
    M33 best{};
    std::vector<uint8_t> best_mask, mask;
    for (int iter = 0; iter < niters; iter++) {
        P2f ms1[4], ms2[4];
        int idx[4];
        int i = 0, iters = 0;
        const int max_attempts = 10000;
        for (; iters < max_attempts; ++iters) {
            for (i = 0; i < model_points; ++i) {
                int idx_i;
                for (idx_i = rng.uniform(0, count); std::find(idx, idx + i, idx_i) != idx + i;
                     idx_i = rng.uniform(0, count)) {
                }
                idx[i] = idx_i;
                ms1[i] = src[idx_i];
                ms2[i] = dst[idx_i];
            }
            if (i == model_points && !homography_subset_ok(ms1, ms2, i)) continue;
            break;
        }
        if (!(i == model_points && iters < max_attempts)) {
            if (iter == 0) return false;
            break;
        }
        M33 model;
        if (!homography_kernel(std::vector<P2f>(ms1, ms1 + 4), std::vector<P2f>(ms2, ms2 + 4), model)) continue;
        int good = homography_inliers(src, dst, model, thresh, mask);
        if (good > std::max(max_good, model_points - 1)) {
            std::swap(mask, best_mask);
            best = model;
            max_good = good;
            niters = ransac_update_num_iters(0.995, (double)(count - good) / count, model_points, niters);
        }
    }
    if (max_good <= 0) return false;
    H = best;
    std::vector<P2f> s1, d1;
    for (int i = 0; i < count; i++)
        if (best_mask[i]) {
            s1.push_back(src[i]);
            d1.push_back(dst[i]);
        }
    if (!s1.empty()) {
        homography_kernel(s1, d1, H);
        homography_refine(s1, d1, H);
    }
    return true;
}

// ------------------------------------------------------------ image warps

inline int cvt_round_f(float v) {
    if (!(v >= -2147483648.f && v < 2147483648.f)) return INT32_MIN;
    return (int)std::nearbyint(v);
}

// warpPerspective(src, M, (w, h), INTER_NEAREST, BORDER_CONSTANT, 0) as
// OpenCV 5's AVX2 kernel computes it: the inverse in float32, 16-pixel
// steps fusing M0·x into y·M1 + M2, the row's tail fusing x·M0 + y·M1
bool warp_perspective_nearest(const Img& src, const M33& H, int w, int h, Img& out) {
    M33 inv;
    if (!invert33(H, inv)) return false;
    float M[9];
    for (int i = 0; i < 9; i++) M[i] = (float)inv[i];
    out = Img(h, w, 0);
    const int nv = (w / 16) * 16;
    for (int y = 0; y < h; y++) {
        const float fy = (float)y;
        float r[3][2];
        for (int k = 0; k < 3; k++) {
            r[k][0] = fy * M[3 * k + 1] + M[3 * k + 2];
            r[k][1] = fy * M[3 * k + 1];
        }
        for (int x = 0; x < w; x++) {
            const float fx = (float)x;
            float c[3];
            for (int k = 0; k < 3; k++)
                c[k] = x < nv ? std::fma(M[3 * k], fx, r[k][0]) : std::fma(fx, M[3 * k], r[k][1]) + M[3 * k + 2];
            int sx = cvt_round_f(c[0] / c[2]), sy = cvt_round_f(c[1] / c[2]);
            if ((unsigned)sx < (unsigned)src.cols && (unsigned)sy < (unsigned)src.rows) out.at(y, x) = src.at(sy, sx);
        }
    }
    return true;
}

Img crop(const Img& m, int y0, int y1, int x0, int x1) {
    Img r(y1 - y0, x1 - x0);
    for (int y = y0; y < y1; y++) std::memcpy(&r.at(y - y0, 0), m.row(y) + x0, (size_t)(x1 - x0));
    return r;
}

Img border_constant(const Img& m, int b, uint8_t v) {
    Img r(m.rows + 2 * b, m.cols + 2 * b, v);
    for (int y = 0; y < m.rows; y++) std::memcpy(&r.at(y + b, b), m.row(y), (size_t)m.cols);
    return r;
}

// --------------------------------------------------------------- resizes

const int kCoefBits = 11, kCoefScale = 1 << kCoefBits;

inline short coef_short(float v) { return (short)std::max(-32768, std::min(32767, cvt_round_f(v))); }

// INTER_AREA where a scale is below 1 (OpenCV emulates it with the linear
// machinery: s = floor(d·scale), f = (d + 1) − (s + 1)·inv_scale), fixed
// point, the vertical pass as its vector loop rounds
Img resize_area_up(const Img& src, int dw, int dh) {
    const int sw = src.cols, sh = src.rows;
    const double ix = (double)dw / sw, iy = (double)dh / sh;
    const double sx_s = 1. / ix, sy_s = 1. / iy;
    std::vector<int> xofs(dw), yofs(dh);
    std::vector<int> a0(dw), a1(dw), b0(dh), b1(dh);
    for (int dx = 0; dx < dw; dx++) {
        int sx = (int)std::floor(dx * sx_s);
        float fx = (float)((dx + 1) - (sx + 1) * ix);
        fx = fx <= 0 ? 0.f : fx - (float)std::floor(fx);
        if (sx < 0) fx = 0, sx = 0;
        if (sx >= sw - 1) fx = 0, sx = sw - 1;
        xofs[dx] = sx;
        a0[dx] = coef_short((1.f - fx) * kCoefScale);
        a1[dx] = coef_short(fx * kCoefScale);
    }
    for (int dy = 0; dy < dh; dy++) {
        int sy = (int)std::floor(dy * sy_s);
        float fy = (float)((dy + 1) - (sy + 1) * iy);
        fy = fy <= 0 ? 0.f : fy - (float)std::floor(fy);
        yofs[dy] = sy;
        b0[dy] = coef_short((1.f - fy) * kCoefScale);
        b1[dy] = coef_short(fy * kCoefScale);
    }
    std::vector<int> rows((size_t)sh * dw);
    for (int y = 0; y < sh; y++) {
        const uint8_t* S = src.row(y);
        for (int dx = 0; dx < dw; dx++) {
            int sx = xofs[dx];
            rows[(size_t)y * dw + dx] = sx + 1 < sw ? S[sx] * a0[dx] + S[sx + 1] * a1[dx] : S[sx] * kCoefScale;
        }
    }
    Img out(dh, dw);
    for (int dy = 0; dy < dh; dy++) {
        const int r0 = std::min(std::max(yofs[dy], 0), sh - 1), r1 = std::min(std::max(yofs[dy] + 1, 0), sh - 1);
        const int* R0 = &rows[(size_t)r0 * dw];
        const int* R1 = &rows[(size_t)r1 * dw];
        for (int x = 0; x < dw; x++) {
            int v = (((R0[x] >> 4) * b0[dy]) >> 16) + (((R1[x] >> 4) * b1[dy]) >> 16);
            v = std::max(-32768, std::min(32767, v));
            v = (v + 2) >> 2;
            out.at(dy, x) = (uint8_t)std::max(0, std::min(255, v));
        }
    }
    return out;
}

struct AreaTap {
    int src;
    float w;
};

// computeResizeAreaTab: each output cell's source samples and weights
std::vector<std::vector<AreaTap>> area_tab(int ssize, int dsize, double scale) {
    std::vector<std::vector<AreaTap>> cells(dsize);
    for (int dx = 0; dx < dsize; dx++) {
        double fsx1 = dx * scale, fsx2 = fsx1 + scale;
        double cell = std::min(scale, ssize - fsx1);
        int sx1 = (int)std::ceil(fsx1), sx2 = (int)std::floor(fsx2);
        sx2 = std::min(sx2, ssize - 1);
        sx1 = std::min(sx1, sx2);
        auto& t = cells[dx];
        if (sx1 - fsx1 > 1e-3) t.push_back({sx1 - 1, (float)((sx1 - fsx1) / cell)});
        for (int sx = sx1; sx < sx2; sx++) t.push_back({sx, (float)(1.0 / cell)});
        if (fsx2 - sx2 > 1e-3) t.push_back({sx2, (float)(std::min(std::min(fsx2 - sx2, 1.), cell) / cell)});
    }
    return cells;
}

// cv::resize(src, (dw, dh), INTER_AREA) on uint8
Img resize_area(const Img& src, int dw, int dh) {
    const int sw = src.cols, sh = src.rows;
    if (sw == dw && sh == dh) return src;
    const double ix = (double)dw / sw, iy = (double)dh / sh;
    const double sx = 1. / ix, sy = 1. / iy;
    if (!(sx >= 1 && sy >= 1)) return resize_area_up(src, dw, dh);
    const int kx = cv_round(sx), ky = cv_round(sy);
    Img out(dh, dw, 0);
    if (std::fabs(sx - kx) < DBL_EPSILON && std::fabs(sy - ky) < DBL_EPSILON) {
        const int fw = std::min(sw / kx, dw), fh = std::min(sh / ky, dh);
        const float inv = 1.f / (float)(kx * ky);
        for (int dy = 0; dy < dh; dy++)
            for (int dx = 0; dx < dw; dx++) {
                int64_t s = 0;
                int n = 0;
                for (int y = dy * ky; y < std::min(dy * ky + ky, sh); y++)
                    for (int x = dx * kx; x < std::min(dx * kx + kx, sw); x++) s += src.at(y, x), n++;
                int v;
                if (dy < fh && dx < fw)
                    v = kx == 2 && ky == 2 ? (int)((s + 2) >> 2) : cvt_round_f((float)s * inv);
                else
                    v = cvt_round_f((float)s / (float)n);
                out.at(dy, dx) = (uint8_t)std::max(0, std::min(255, v));
            }
        return out;
    }
    auto xt = area_tab(sw, dw, sx), yt = area_tab(sh, dh, sy);
    std::vector<float> buf((size_t)sh * dw, 0.f);
    size_t nx = 0;
    for (auto& t : xt) nx = std::max(nx, t.size());
    for (size_t t = 0; t < nx; t++)
        for (int y = 0; y < sh; y++)
            for (int dx = 0; dx < dw; dx++) {
                if (t >= xt[dx].size()) continue;
                float& b = buf[(size_t)y * dw + dx];
                b = b + (float)src.at(y, xt[dx][t].src) * xt[dx][t].w;
            }
    size_t ny = 0;
    for (auto& t : yt) ny = std::max(ny, t.size());
    std::vector<float> acc((size_t)dh * dw, 0.f);
    for (size_t t = 0; t < ny; t++)
        for (int dy = 0; dy < dh; dy++) {
            if (t >= yt[dy].size()) continue;
            for (int dx = 0; dx < dw; dx++) {
                float& a = acc[(size_t)dy * dw + dx];
                a = a + yt[dy][t].w * buf[(size_t)yt[dy][t].src * dw + dx];
            }
        }
    for (int dy = 0; dy < dh; dy++)
        for (int dx = 0; dx < dw; dx++)
            out.at(dy, dx) = (uint8_t)std::max(0, std::min(255, cvt_round_f(acc[(size_t)dy * dw + dx])));
    return out;
}

// -------------------------------------------------------- template match

// matchTemplate(img, templ, TM_CCOEFF_NORMED) and minMaxLoc's maximum (the
// first in row order), as common_matchTemplate scores it: the window sums
// and the template's mean and deviation in double, the cross-correlation a
// float32 (here summed exactly, then rounded to float32)
void match_template_max(const Img& img, const Img& tpl, double& max_val, P2i& max_loc) {
    const int th = tpl.rows, tw = tpl.cols;
    const int rh = img.rows - th + 1, rw = img.cols - tw + 1;
    const double inv_area = 1. / ((double)th * tw);
    double tsum = 0, tsq = 0;
    for (int y = 0; y < th; y++)
        for (int x = 0; x < tw; x++) {
            tsum += tpl.at(y, x);
            tsq += (double)tpl.at(y, x) * tpl.at(y, x);
        }
    const double tmean = tsum * inv_area;
    const double tsdv = std::sqrt(std::max(tsq * inv_area - tmean * tmean, 0.));
    double tnorm = tsdv * tsdv;
    max_val = -DBL_MAX;
    max_loc = P2i(0, 0);
    if (tnorm < DBL_EPSILON) {  // a flat template scores 1 everywhere
        max_val = 1.;
        return;
    }
    tnorm = std::sqrt(tnorm) / std::sqrt(inv_area);
    // integral images of the window
    const int W = img.cols + 1;
    std::vector<double> S((size_t)(img.rows + 1) * W, 0.), Q((size_t)(img.rows + 1) * W, 0.);
    for (int y = 0; y < img.rows; y++) {
        double rs = 0, rq = 0;
        for (int x = 0; x < img.cols; x++) {
            double v = img.at(y, x);
            rs += v;
            rq += v * v;
            S[(size_t)(y + 1) * W + x + 1] = S[(size_t)y * W + x + 1] + rs;
            Q[(size_t)(y + 1) * W + x + 1] = Q[(size_t)y * W + x + 1] + rq;
        }
    }
    bool first = true;
    for (int y = 0; y < rh; y++)
        for (int x = 0; x < rw; x++) {
            int64_t cc = 0;
            for (int i = 0; i < th; i++) {
                const uint8_t* I = img.row(y + i) + x;
                const uint8_t* T = tpl.row(i);
                for (int j = 0; j < tw; j++) cc += (int)I[j] * T[j];
            }
            double num = (float)cc;
            double t = S[(size_t)y * W + x] - S[(size_t)y * W + x + tw] - S[(size_t)(y + th) * W + x] +
                       S[(size_t)(y + th) * W + x + tw];
            double wnd_mean2 = t * t;
            num -= t * tmean;
            wnd_mean2 *= inv_area;
            double wnd_sum2 = Q[(size_t)y * W + x] - Q[(size_t)y * W + x + tw] - Q[(size_t)(y + th) * W + x] +
                              Q[(size_t)(y + th) * W + x + tw];
            double diff2 = std::max(wnd_sum2 - wnd_mean2, 0.);
            if (diff2 <= std::min(0.5, 10 * FLT_EPSILON * wnd_sum2))
                t = 0;
            else
                t = std::sqrt(diff2) * tnorm;
            if (std::fabs(num) < t)
                num /= t;
            else if (std::fabs(num) < t * 1.125)
                num = num > 0 ? 1 : -1;
            else
                num = 0;
            float rf = (float)num;
            if (first || rf > max_val) {
                max_val = rf;
                max_loc = P2i(x, y);
                first = false;
            }
        }
}

// ----------------------------------------------------------- QR symbology

// per version: the alignment pattern centres (OpenCV's version table)
std::vector<int> alignment_centres(int v) {
    std::vector<int> out;
    if (v < 2) return out;
    const int num = v / 7 + 2, size = 4 * v + 17;
    int step = v == 32 ? 26 : (v * 4 + num * 2 + 1) / (num * 2 - 2) * 2;
    out.assign(num, 0);
    out[0] = 6;
    for (int i = num - 1, pos = size - 7; i >= 1; i--, pos -= step) out[i] = pos;
    return out;
}

// error correction blocks per version (1..40) and level (L, M, Q, H)
const int8_t kEccPerBlock[4][41] = {
    {-1, 7, 10, 15, 20, 26, 18, 20, 24, 30, 18, 20, 24, 26, 30, 22, 24, 28, 30, 28, 28,
     28, 28, 30, 30, 26, 28, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30},
    {-1, 10, 16, 26, 18, 24, 16, 18, 22, 22, 26, 30, 22, 22, 24, 24, 28, 28, 26, 26, 26,
     26, 28, 28, 28, 28, 28, 28, 28, 28, 28, 28, 28, 28, 28, 28, 28, 28, 28, 28, 28},
    {-1, 13, 22, 18, 26, 18, 24, 18, 22, 20, 24, 28, 26, 24, 20, 30, 24, 28, 28, 26, 30,
     28, 30, 30, 30, 30, 28, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30},
    {-1, 17, 28, 22, 16, 22, 28, 26, 26, 24, 28, 24, 28, 22, 24, 24, 30, 28, 28, 26, 28,
     30, 24, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30}};
const int8_t kNumBlocks[4][41] = {
    {-1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 4, 4, 4, 4, 4, 6, 6, 6, 6, 7, 8,
     8, 9, 9, 10, 12, 12, 12, 13, 14, 15, 16, 17, 18, 19, 19, 20, 21, 22, 24, 25},
    {-1, 1, 1, 1, 2, 2, 4, 4, 4, 5, 5, 5, 8, 9, 9, 10, 10, 11, 13, 14, 16,
     17, 17, 18, 20, 21, 23, 25, 26, 28, 29, 31, 33, 35, 37, 38, 40, 43, 45, 47, 49},
    {-1, 1, 1, 2, 2, 4, 4, 6, 6, 8, 8, 8, 10, 12, 16, 12, 17, 16, 18, 21, 20,
     23, 23, 25, 27, 29, 34, 34, 35, 38, 40, 43, 45, 48, 51, 53, 56, 59, 62, 65, 68},
    {-1, 1, 1, 2, 4, 4, 4, 5, 6, 8, 8, 11, 11, 16, 16, 18, 16, 19, 21, 25, 25,
     25, 34, 30, 32, 35, 37, 40, 42, 45, 48, 51, 54, 57, 60, 63, 66, 70, 74, 77, 81}};

int total_codewords(int v) {
    int r = (16 * v + 128) * v + 64;
    if (v >= 2) {
        int na = v / 7 + 2;
        r -= (25 * na - 10) * na - 55;
        if (v >= 7) r -= 36;
    }
    return r / 8;
}

// the (masked) format words of data 0..31, in OpenCV's table order
const uint16_t kFormatWords[32] = {0x5412, 0x5125, 0x5e7c, 0x5b4b, 0x45f9, 0x40ce, 0x4f97, 0x4aa0,
                                   0x77c4, 0x72f3, 0x7daa, 0x789d, 0x662f, 0x6318, 0x6c41, 0x6976,
                                   0x1689, 0x13be, 0x1ce7, 0x19d0, 0x0762, 0x0255, 0x0d0c, 0x083b,
                                   0x355f, 0x3068, 0x3f31, 0x3a06, 0x24b4, 0x2183, 0x2eda, 0x2bed};

// the 18-bit version information of versions 7..40
int version_info_bits(int v) {
    int rem = v;
    for (int i = 0; i < 12; i++) rem = (rem << 1) ^ ((rem >> 11) * 0x1F25);
    return v << 12 | rem;
}

// GF(256), x^8 + x^4 + x^3 + x^2 + 1
struct Gf {
    uint8_t exp[512], log[256];
    Gf() {
        int x = 1;
        for (int i = 0; i < 255; i++) {
            exp[i] = (uint8_t)x;
            log[x] = (uint8_t)i;
            x <<= 1;
            if (x & 0x100) x ^= 0x11d;
        }
        for (int i = 255; i < 512; i++) exp[i] = exp[i - 255];
        log[0] = 0;
    }
    uint8_t mul(uint8_t a, uint8_t b) const { return a && b ? exp[log[a] + log[b]] : 0; }
    uint8_t div(uint8_t a, uint8_t b) const { return a ? exp[(log[a] + 255 - log[b]) % 255] : 0; }
    uint8_t pow2(int i) const { return exp[((i % 255) + 255) % 255]; }
};
const Gf gf;

// cv::Exception raised inside the decoder (cv2.error to Python)
struct CvError {};

const char kAlnum[64] = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ $%*+-./:";
const uint8_t kInvalidRegion = 110;

// QRCodeDecoderImpl: a square module grid (0 dark, 255 light) → the payload
struct GridDecoder {
    int version = 0, level = 0;  // level: 0 L, 1 M, 2 Q, 3 H
    int mode = 0, eci = 0;
    uint8_t sequence_num = 0, total_num = 1, parity = 0;
    std::vector<uint8_t> data;
    int actual_bits = 8;
    size_t idx = 0;

    int next(int bits) {
        int val = 0;
        while (bits >= actual_bits) {
            if (idx >= data.size()) throw CvError();  // "Not enough bits in the bitstream"
            val |= data[idx++] << (bits - actual_bits);
            bits -= actual_bits;
            actual_bits = 8;
        }
        if (bits && idx < data.size()) {
            val |= data[idx] >> (actual_bits - bits);
            actual_bits -= bits;
            data[idx] &= 255 >> (8 - actual_bits);
        }
        return val;
    }
    bool empty() const { return idx >= data.size(); }

    static bool correct_format(uint16_t& f) {
        for (int k = 0; k < 32; k++)
            if (__builtin_popcount((unsigned)(kFormatWords[k] ^ f)) <= 3) {
                f = kFormatWords[k] ^ 0x5412;
                return true;
            }
        return false;
    }

    bool decode_format(const Img& s, int& mask) {
        auto b = [&](int r, int c) { return s.at(r, c) & 1; };
        uint16_t f = 0;
        for (int i = 0; i < 6; i++) f |= b(i, 8) << i;
        f |= b(7, 8) << 6;
        f |= b(8, 8) << 7;
        f |= b(8, 7) << 8;
        for (int i = 9; i < 15; i++) f |= b(8, 14 - i) << i;
        bool correct = correct_format(f);
        uint16_t d = 0;
        for (int i = 0; i < 8; i++) d |= b(8, s.cols - 1 - i) << i;
        for (int i = 0; i < 7; i++) d |= b(s.rows - 7 + i, 8) << (i + 8);
        if (correct_format(d)) {
            if (correct && f != d) return false;
            f = d;
        } else if (!correct) {
            return false;
        }
        static const int levels[4] = {1, 0, 3, 2};  // format bits 00 M, 01 L, 10 H, 11 Q
        level = levels[(f >> 13) & 3];
        mask = (f >> 10) & 7;
        return true;
    }

    static void mask_data(Img& s, int mask) {
        for (int i = 0; i < s.rows; i++)
            for (int j = 0; j < s.cols; j++) {
                uint8_t v = s.at(i, j);
                if (v == kInvalidRegion) continue;
                bool flip;
                switch (mask) {
                    case 0: flip = (i + j) % 2 == 0; break;
                    case 1: flip = i % 2 == 0; break;
                    case 2: flip = j % 3 == 0; break;
                    case 3: flip = (i + j) % 3 == 0; break;
                    case 4: flip = (i / 2 + j / 3) % 2 == 0; break;
                    case 5: flip = (i * j) % 2 + (i * j) % 3 == 0; break;
                    case 6: flip = ((i * j) % 2 + (i * j) % 3) % 2 == 0; break;
                    default: flip = ((i + j) % 2 + (i * j) % 3) % 2 == 0; break;
                }
                if (flip) s.at(i, j) = (uint8_t)~v;
            }
    }

    void fill(Img& s, int r0, int r1, int c0, int c1) {
        for (int r = std::max(r0, 0); r < std::min(r1, s.rows); r++)
            for (int c = std::max(c0, 0); c < std::min(c1, s.cols); c++) s.at(r, c) = kInvalidRegion;
    }

    void extract_codewords(Img& s) {
        const int n = s.rows;
        // OpenCV's version table, whose last version-21 centre is 92, not 94
        std::vector<int> ac = alignment_centres(version);
        if (version == 21) ac.back() = 92;
        const size_t na = ac.size();
        for (size_t i = 0; i < na; i++)
            for (size_t j = 0; j < na; j++) {
                if ((i == na - 1 && j == 0) || (i == 0 && j == 0) || (j == na - 1 && i == 0)) continue;
                fill(s, ac[i] - 2, ac[i] + 3, ac[j] - 2, ac[j] + 3);
            }
        fill(s, 0, 9, n - 8, n);
        fill(s, 0, 9, 0, 9);
        fill(s, n - 8, n, 0, 9);
        if (version >= 7) {  // OpenCV's version blocks sit one module left of (above) the code's
            fill(s, 0, 6, n - 12, n - 9);
            fill(s, n - 12, n - 9, 0, 6);
        }
        fill(s, 6, 7, 0, n);
        fill(s, 0, n, 6, 7);
        data.clear();
        int bits = 0, byte = 0;
        bool up = true;
        for (int x = n - 1; x > 0; x -= 2) {
            if (x == 6) x--;
            for (int k = 0; k < n; k++) {
                int y = up ? n - 1 - k : k;
                for (int c = x; c > x - 2; c--) {
                    uint8_t v = s.at(y, c);
                    if (v == kInvalidRegion) continue;
                    byte = (byte << 1) | (v & 1);
                    if (++bits == 8) {
                        data.push_back((uint8_t)byte);
                        bits = byte = 0;
                    }
                }
            }
            up = !up;
        }
    }

    int ecc_len() const { return kEccPerBlock[level][version]; }

    // errorCorrectionBlock, as OpenCV 5.0 computes it: an even number of
    // syndromes (the ECC count rounded down), Berlekamp-Massey whose update
    // runs over the first L coefficients of B only and which raises where
    // m + L - 1 reaches the polynomials' size, the roots of the locator,
    // and Forney's values as Ω(X⁻¹) / Π(1 + X_j·X⁻¹), an error skipped
    // where either is 0; the ECC codewords trimmed
    bool correct_block(std::vector<uint8_t>& cw) {
        const size_t num_ecc = ecc_len(), n = cw.size();
        const size_t ns = num_ecc - (num_ecc & 1);
        std::vector<uint8_t> syn(ns, cw[0]);
        bool has_error = false;
        for (size_t i = 0; i < ns; i++) {
            for (size_t j = 1; j < n; j++) syn[i] = gf.mul(syn[i], gf.pow2((int)i)) ^ cw[j];
            has_error |= syn[i] != 0;
        }
        if (!has_error) {
            cw.resize(n - num_ecc);
            return true;
        }
        size_t L = 0, m = 1;
        uint8_t b = 1;
        std::vector<uint8_t> C(ns, 0), B(ns, 0);
        C[0] = B[0] = 1;
        for (size_t i = 0; i < ns; i++) {
            if (L + m - 1 >= C.size()) throw CvError();  // CV_Assert(m + L - 1 < C.size())
            uint8_t d = syn[i];
            for (size_t j = 1; j <= L; j++) d ^= gf.mul(C[j], syn[i - j]);
            if (d == 0) {
                m += 1;
                continue;
            }
            std::vector<uint8_t> Cc = C;
            const uint8_t coeff = gf.div(d, b);
            for (size_t j = 0; j < L; j++) C[m + j] ^= gf.mul(coeff, B[j]);
            if (2 * L <= i) {
                L = i + 1 - L;
                B = Cc;
                b = d;
                m = 1;
            } else {
                m += 1;
            }
        }
        std::vector<size_t> locs;
        for (size_t i = 0; i < n; i++) {
            uint8_t val = 1;
            const uint8_t pos = gf.pow2((int)i);
            for (size_t j = 1; j <= L; j++) val = gf.mul(val, pos) ^ C[j];
            if (val == 0) locs.push_back(n - 1 - i);
        }
        if (locs.size() != L) return false;
        std::vector<uint8_t> ev(C.size() + syn.size() - 1, 0);
        for (size_t a = 0; a < C.size(); a++)
            for (size_t k = 0; k < syn.size(); k++) ev[a + k] ^= gf.mul(C[a], syn[k]);
        std::vector<uint8_t> X(locs.size());
        for (size_t k = 0; k < locs.size(); k++) X[k] = gf.pow2((int)(n - 1 - locs[k]));
        for (size_t k = 0; k < locs.size(); k++) {
            const uint8_t inv_x = gf.div(1, X[k]);
            uint8_t num = 0;
            for (size_t j = L; j-- > 0;) num = gf.mul(num, inv_x) ^ ev[j];
            uint8_t den = 1;
            for (size_t q = 0; q < locs.size(); q++)
                if (q != k) den = gf.mul(den, 1 ^ gf.mul(X[q], inv_x));
            if (num == 0 || den == 0) continue;
            cw[locs[k]] ^= gf.div(num, den);
        }
        cw.resize(n - num_ecc);
        return true;
    }

    bool error_correction() {
        const int total = total_codewords(version);
        if ((int)data.size() < total) throw CvError();  // CV_CheckEQ on the codeword count
        data.resize(total);
        const int nb = kNumBlocks[level][version], ecc = ecc_len();
        const int short_len = total / nb, n_long = total % nb, n_short = nb - n_long;
        std::vector<int> sizes;
        size_t num_data = 0;
        for (int i = 0; i < nb; i++) {
            sizes.push_back(short_len - ecc + (i >= n_short ? 1 : 0));
            num_data += sizes.back();
        }
        if (nb == 1) return correct_block(data);
        std::vector<std::vector<uint8_t>> blocks(nb);
        const int min_size = *std::min_element(sizes.begin(), sizes.end());
        size_t off = 0;
        for (int i = 0; i < min_size; i++)
            for (int j = 0; j < nb; j++) blocks[j].push_back(data[off++]);
        for (int j = 0; j < nb; j++)
            if (sizes[j] > min_size) blocks[j].push_back(data[off++]);
        for (int i = 0; i < ecc; i++)
            for (int j = 0; j < nb; j++) blocks[j].push_back(data[off++]);
        // parallel_for_ over the blocks: every block is corrected (a raise
        // in any of them raises), a failed one fails the whole
        bool ok = true;
        for (int j = 0; j < nb; j++)
            if (!correct_block(blocks[j])) ok = false;
        if (!ok) return false;
        data.clear();
        for (auto& bl : blocks) data.insert(data.end(), bl.begin(), bl.end());
        data.resize(num_data);
        return true;
    }

    void decode_numeric(std::string& out) {
        int n = next(version <= 9 ? 10 : (version <= 26 ? 12 : 14));
        for (int i = 0; i < n / 3; i++) {
            int t = next(10);
            out += (char)('0' + t / 100);
            out += (char)('0' + (t / 10) % 10);
            out += (char)('0' + t % 10);
        }
        int rem = n % 3;
        if (rem) {
            int t = next(rem == 1 ? 4 : 7);
            if (rem == 2) out += (char)('0' + (t / 10) % 10);
            out += (char)('0' + t % 10);
        }
    }

    void decode_alpha(std::string& out) {
        int n = next(version <= 9 ? 9 : (version <= 26 ? 11 : 13));
        for (int i = 0; i < n / 2; i++) {
            int t = next(11);
            out += kAlnum[std::min(t / 45, 63)];
            out += kAlnum[t % 45];
        }
        if (n % 2) out += kAlnum[next(6)];
    }

    void decode_byte(std::string& out) {
        int n = next(version <= 9 ? 8 : 16);
        for (int i = 0; i < n; i++) out += (char)next(8);
    }

    void decode_kanji(std::string& out) {
        int n = next(version <= 9 ? 8 : (version <= 26 ? 10 : 12));
        for (int i = 0; i < n; i++) {
            int d = next(13);
            int sym = ((d / 0xC0) << 8) | (d % 0xC0);
            sym += sym < 0x1F00 ? 0x8140 : 0xC140;
            out += (char)(sym >> 8);
            out += (char)(sym & 0xff);
        }
    }

    // decodeECI: the designator's first byte and, for each of its leading
    // one bits, one more byte above it; then the segments that follow, read
    // by a nested decodeSymbols (which starts the payload over)
    void decode_eci(std::string& out) {
        if (empty()) throw CvError();  // CV_Assert(!bitstream.empty())
        int v = next(8);
        for (int i = 0; i < 8; i++) {
            if (!(v & (1 << (7 - i)))) break;
            if (empty()) throw CvError();
            v |= next(8) << ((i + 1) * 8);
        }
        if (eci == 0) eci = v;
        decode_symbols(out);
    }

    void decode_symbols(std::string& out) {
        if (empty()) throw CvError();
        out.clear();
        while (!empty()) {
            int m = next(4);
            if (mode == 0) mode = m;
            if (m == 0 || empty()) return;
            switch (m) {
                case 1: decode_numeric(out); break;
                case 2: decode_alpha(out); break;
                case 3: {
                    int seq = next(8);
                    sequence_num = (uint8_t)(seq >> 4);
                    total_num = (uint8_t)(1 + (seq & 0xf));
                    parity = (uint8_t)next(8);
                    break;
                }
                case 4: decode_byte(out); break;
                case 7: decode_eci(out); break;
                case 8: decode_kanji(out); break;
                default: throw CvError();  // "mode %d" is not implemented
            }
        }
    }

    // run(): format information from ``s``, the codewords from a masked copy
    bool run(const Img& s, std::string& out) {
        version = (s.rows - 21) / 4 + 1;
        out.clear();
        mode = eci = 0;
        int mask;
        if (!decode_format(s, mask)) return false;
        Img masked = s;
        mask_data(masked, mask);
        extract_codewords(masked);
        actual_bits = 8;
        idx = 0;
        if (!error_correction()) return false;
        decode_symbols(out);
        return true;
    }

    // decode(): the inverted grid (dark 255), then its transpose (a
    // mirrored code)
    bool decode(const Img& straight, std::string& out) {
        Img s(straight.rows, straight.cols);
        for (size_t i = 0; i < s.d.size(); i++) s.d[i] = (uint8_t)~straight.d[i];
        if (run(s, out)) return true;
        Img t(s.cols, s.rows);
        for (int r = 0; r < s.rows; r++)
            for (int c = 0; c < s.cols; c++) t.at(c, r) = s.at(r, c);
        return run(t, out);
    }
};

// ------------------------------------------------------------- QRDecode

inline double norm_pts(P2f a, P2f b) {
    double dx = a.x - b.x, dy = a.y - b.y;
    return std::sqrt(dx * dx + dy * dy);
}

// libstdc++'s std::sort on (index, cosine) pairs, the sharpest corner first
bool by_cos_desc(const std::pair<size_t, double>& a, const std::pair<size_t, double>& b) { return a.second > b.second; }

struct QRDecode {
    bool use_alignment = true;
    Img original, bin;
    Img no_border, intermediate, straight;
    std::vector<P2f> original_points;
    std::vector<P2f> alignment_coords;
    M33 homography{};
    bool have_homography = false;
    int version = 0, version_size = 0;
    float tps = 251.f;  // test_perspective_size
    std::string result;
    GridDecoder dec;
    // what decodingProcess copies from the decoder where it decodes: the
    // first segment's mode (-1 before) and the structured-append header
    int mode = -1;
    uint8_t parity = 0, sequence_num = 0, total_num = 1;

    void init(const Img& src, const std::vector<P2f>& pts) {
        original = src;
        bin = adaptive_threshold(src, 83, 2.0);
        original_points = pts;
        alignment_coords.clear();
        have_homography = false;
        version = version_size = 0;
        // the shortest side of the quad, its float differences squared in double
        double d01 = norm2f(pts[1] - pts[0]), d12 = norm2f(pts[1] - pts[2]);
        double d23 = norm2f(pts[2] - pts[3]), d30 = norm2f(pts[3] - pts[0]);
        float min_side = (float)std::min(std::min(std::min(d12, d01), d23), d30);
        float v = min_side + 1.f;
        tps = 251.f > v ? 251.f : v;
        result.clear();
    }

    bool update_perspective(const M33& H) {
        homography = H;
        have_homography = true;
        const int side = cvt_round_f(tps);
        Img temp;
        if (!warp_perspective_nearest(bin, H, side, side, temp)) throw CvError();
        no_border = crop(temp, 1, temp.rows, 1, temp.cols);
        const int border = cv_round((double)tps * 0.1);
        intermediate = border_constant(no_border, border, 255);
        return true;
    }

    // findPatternsVerticesPoints: the three finder patterns in the binary
    // frame, each as the four sharpest corners of its hull
    bool finder_patterns(std::vector<std::vector<P2i>>& patterns) {
        const int rows = bin.rows, cols = bin.cols;
        Img mask = new_fill_mask(rows, cols);
        std::vector<int> acc((size_t)(rows + 2) * (cols + 2), 0);
        for (size_t c = 0; c < original_points.size(); c++) {
            if (c == 2) continue;
            const int px = (int)original_points[c].x, py = (int)original_points[c].y;
            const int x0 = std::max(px - 2, 0), x1 = std::min(cols - 1, px + 2);
            const int y0 = std::max(py - 2, 0), y1 = std::min(rows - 1, py + 2);
            int sx = 0, sy = 0;
            for (int x = x0; x <= x1; x++)
                for (int y = y0; y <= y1; y++)
                    if (bin.at(y, x) == 0) sx = x, sy = y;
            flood_fill_mask(bin, mask, P2i(sx, sy));
            for (size_t i = 0; i < acc.size(); i++) acc[i] = std::min(255, acc[i] + mask.d[i]);
        }
        // acc(Range(1, rows - 1), Range(1, cols - 1)), its outer contours
        Img roi(rows - 2, cols - 2, 0);
        for (int y = 0; y < rows - 2; y++)
            for (int x = 0; x < cols - 2; x++) roi.at(y, x) = acc[(size_t)(y + 1) * (cols + 2) + x + 1] != 0;
        std::vector<std::vector<P2i>> outer = outer_components(roi);
        if (outer.size() != 3) return false;
        for (auto& comp : outer) {
            std::vector<P2i> hull = convex_hull_i(comp);
            const size_t n = hull.size();
            std::vector<std::pair<size_t, double>> angles;
            for (size_t i = 1; i < n + 1; i++) {
                P2i c = hull[i % n], a = hull[(i - 1) % n], b = hull[(i + 1) % n];
                int v1x = a.x - c.x, v1y = a.y - c.y, v2x = b.x - c.x, v2y = b.y - c.y;
                double dot = (double)(v1x * v2x + v1y * v2y);
                double n1 = std::sqrt((double)v1x * v1x + (double)v1y * v1y);
                double n2 = std::sqrt((double)v2x * v2x + (double)v2y * v2y);
                angles.push_back({i, dot / (n1 * n2)});
            }
            std::sort(angles.begin(), angles.end(), by_cos_desc);
            std::vector<size_t> chosen;
            for (size_t k = 0; k < angles.size(); k++) {
                P2i p = hull[angles[k].first % n];
                bool far = true;
                for (size_t q : chosen) {
                    double dx = p.x - hull[q].x, dy = p.y - hull[q].y;
                    far &= std::sqrt(dx * dx + dy * dy) >= 3.0;
                }
                if (far) {
                    chosen.push_back(angles[k].first % n);
                    if (chosen.size() == 4) break;
                }
            }
            std::sort(chosen.begin(), chosen.end());
            std::vector<P2i> pat;
            for (size_t q : chosen) pat.push_back(hull[q]);
            patterns.push_back(pat);
        }
        return patterns.size() == 3;
    }

    // the 8-connected components of ``roi`` not inside another one's hole:
    // findContours(RETR_EXTERNAL)'s contours, as point sets
    static std::vector<std::vector<P2i>> outer_components(const Img& roi) {
        std::vector<std::vector<P2i>> out;
        std::vector<int> lab((size_t)roi.rows * roi.cols, -1);
        std::vector<std::vector<P2i>> comps;
        for (int y = 0; y < roi.rows; y++)
            for (int x = 0; x < roi.cols; x++) {
                if (!roi.at(y, x) || lab[(size_t)y * roi.cols + x] >= 0) continue;
                int id = (int)comps.size();
                comps.push_back({});
                std::vector<P2i> st{P2i(x, y)};
                lab[(size_t)y * roi.cols + x] = id;
                while (!st.empty()) {
                    P2i p = st.back();
                    st.pop_back();
                    comps[id].push_back(p);
                    for (int dy = -1; dy <= 1; dy++)
                        for (int dx = -1; dx <= 1; dx++) {
                            int nx = p.x + dx, ny = p.y + dy;
                            if ((unsigned)nx >= (unsigned)roi.cols || (unsigned)ny >= (unsigned)roi.rows) continue;
                            size_t k = (size_t)ny * roi.cols + nx;
                            if (!roi.at(ny, nx) || lab[k] >= 0) continue;
                            lab[k] = id;
                            st.push_back(P2i(nx, ny));
                        }
                }
            }
        // a component is enclosed when the background next to it (the pixel
        // left of its first pixel in row order) is a hole: a background
        // region not 4-connected to the frame
        std::vector<int> bg((size_t)roi.rows * roi.cols, -1);
        {
            std::vector<P2i> st;
            for (int y = 0; y < roi.rows; y++)
                for (int x = 0; x < roi.cols; x++)
                    if ((y == 0 || x == 0 || y == roi.rows - 1 || x == roi.cols - 1) && !roi.at(y, x)) {
                        bg[(size_t)y * roi.cols + x] = 1;
                        st.push_back(P2i(x, y));
                    }
            while (!st.empty()) {
                P2i p = st.back();
                st.pop_back();
                const int nx[4] = {p.x + 1, p.x - 1, p.x, p.x}, ny[4] = {p.y, p.y, p.y + 1, p.y - 1};
                for (int k = 0; k < 4; k++) {
                    if ((unsigned)nx[k] >= (unsigned)roi.cols || (unsigned)ny[k] >= (unsigned)roi.rows) continue;
                    size_t q = (size_t)ny[k] * roi.cols + nx[k];
                    if (roi.at(ny[k], nx[k]) || bg[q] >= 0) continue;
                    bg[q] = 1;
                    st.push_back(P2i(nx[k], ny[k]));
                }
            }
        }
        for (auto& c : comps) {
            P2i f = c[0];
            if (f.x == 0 || bg[(size_t)f.y * roi.cols + f.x - 1] == 1) out.push_back(c);
        }
        return out;
    }

    // getNumModules by the finder patterns (0 where they are not usable)
    double modules_by_finders() {
        std::vector<std::vector<P2i>> pats;
        if (!finder_patterns(pats)) return 0.;
        double pix[4] = {0, 0, 0, 0};
        const std::vector<P2f>& op = original_points;
        for (auto& pat : pats) {
            if (pat.size() != 4) return 0.;
            float sides[4];
            for (int k = 0; k < 4; k++) {
                float dx = (float)(pat[k].x - pat[(k + 1) % 4].x), dy = (float)(pat[k].y - pat[(k + 1) % 4].y);
                sides[k] = std::sqrt(dx * dx + dy * dy);
            }
            float mx = std::max(std::max(sides[0], sides[1]), std::max(sides[2], sides[3]));
            float mn = std::min(std::min(sides[0], sides[1]), std::min(sides[2], sides[3]));
            if (1.f - mn / mx > 0.3f) return 0.;
            float dist;
            {
                float dx = (float)pat[0].x - op[0].x, dy = (float)pat[0].y - op[0].y;
                dist = dx * dx + dy * dy;
            }
            int fi = 0, oi = 0;
            for (int i = 0; i < 4; i++)
                for (size_t j = 0; j < op.size(); j++) {
                    float dx = (float)pat[i].x - op[j].x, dy = (float)pat[i].y - op[j].y;
                    float t = dy * dy + dx * dx;
                    if (dist > t) fi = i, oi = (int)j;
                    dist = t < dist ? t : dist;
                }
            float d03, d01;
            {
                float ax = op[0].x - op[3].x, ay = op[0].y - op[3].y;
                float bx = op[0].x - op[1].x, by = op[0].y - op[1].y;
                d03 = std::sqrt(ax * ax + ay * ay);
                d01 = std::sqrt(by * by + bx * bx);
            }
            if (std::sqrt(dist) / (d03 * 0.5f + d01 * 0.5f) > 0.1f) return 0.;
            P2f q[4];
            for (int k = 0; k < 4; k++) q[k] = P2f((float)pat[(fi + k) % 4].x, (float)pat[(fi + k) % 4].y);
            auto side = [](P2f a, P2f b) {
                double dx = (double)(b.x - a.x), dy = (double)(b.y - a.y);
                return std::sqrt(dx * dx + dy * dy);
            };
            double s = pix[oi] + side(q[0], q[1]);
            s = side(q[1], q[2]) + s;
            s = side(q[2], q[3]) + s;
            s = side(q[3], q[0]) + s;
            pix[oi] = s * 0.25;
        }
        double px = (pix[1] + pix[0]) / 14.0, py = (pix[0] + pix[3]) / 14.0;
        double nx = norm2f(op[1] - op[0]) / px, ny = norm2f(op[3] - op[0]) / py;
        return (ny + nx) * 0.5;
    }

    // getVersionByCode: the version information blocks against every
    // version's code → (distance, version)
    std::pair<double, int> version_by_code(int v_est, double num_modules) {
        const Img& img = no_border;
        const double ms = img.rows / num_modules;
        auto rect = [](double x0, double y0, double x1, double y1, int& rx, int& ry, int& rw, int& rh) {
            rx = cv_round(std::min(x0, x1));
            ry = cv_round(std::min(y0, y1));
            rw = cv_round(std::max(x0, x1) - std::min(x0, x1));
            rh = cv_round(std::max(y0, y1) - std::min(y0, y1));
        };
        int x, y, w, h;
        rect((num_modules - 8.0) * ms, 0., (num_modules - 8.0 - 3.0) * ms, 6.0 * ms, x, y, w, h);
        if (x < 0 || y < 0 || w < 0 || h < 0 || x + w > img.cols || y + h > img.rows) throw CvError();
        Img a1 = resize_area(crop(img, y, y + h, x, x + w), 3, 6);
        if (y < 0 || x < 0 || y + h > img.cols || x + w > img.rows) throw CvError();
        Img a2 = resize_area(crop(img, x, x + w, y, y + h), 6, 3);
        // (255 - threshold(a, 127)) / 255, rotated by 180 degrees (the second
        // transposed first): 1 where dark
        int bits1[18], bits2[18];
        for (int r = 0; r < 6; r++)
            for (int c = 0; c < 3; c++) {
                bits1[(5 - r) * 3 + (2 - c)] = a1.at(r, c) > 127 ? 0 : 1;
                bits2[(5 - r) * 3 + (2 - c)] = a2.at(c, r) > 127 ? 0 : 1;
            }
        double best = 19.0;
        int best_v = -1;
        for (int v = 7; v <= 40; v++) {
            const int code = version_info_bits(v);
            int d1 = 0, d2 = 0;
            for (int k = 0; k < 18; k++) {
                int bit = (code >> (17 - k)) & 1;
                d1 += bits1[k] != bit;
                d2 += bits2[k] != bit;
            }
            double pen = std::abs(v_est - v) * 0.8;
            double t = d1 + pen;
            if (best > t) best_v = v;
            best = t < best ? t : best;
            t = d2 + pen;
            if (best > t) best_v = v;
            best = t < best ? t : best;
        }
        return {best, best_v};
    }

    bool version_definition() {
        const Img& im = intermediate;
        const int tr = cvt_round_f(tps);
        P2i black(0, 0);
        for (const P2i& p : line_points(im.cols, im.rows, P2i(0, 0), P2i(tr, tr))) {
            if (im.at(p.y, p.x) == 0) {
                black = p;
                break;
            }
        }
        Img mask = new_fill_mask(im.rows, im.cols);
        std::vector<P2i> filled;
        flood_fill_mask(im, mask, black, &filled);
        std::vector<P2i> nz = mask_roi_nonzero(filled, im.rows, im.cols);
        if (nz.empty()) throw CvError();
        std::vector<P2i> locs = convex_hull_i(nz);
        int minx = INT32_MAX, maxx = INT32_MIN, miny = INT32_MAX, maxy = INT32_MIN;
        for (const P2i& p : locs) {
            minx = std::min(minx, p.x), maxx = std::max(maxx, p.x);
            miny = std::min(miny, p.y), maxy = std::max(maxy, p.y);
        }
        const P2i delta((maxx - minx + 1) / 14, (maxy - miny + 1) / 14);
        const P2i half(delta.x / 2, delta.y / 2);
        auto dist = [&](P2i p) {
            double dx = black.x - p.x, dy = black.y - p.y;
            return std::sqrt(dx * dx + dy * dy);
        };
        P2i temp = locs[0], remote(0, 0);
        for (size_t i = 0; i < locs.size(); i++) {
            if (dist(temp) <= dist(locs[i])) {
                P2i q(temp.x - delta.x, temp.y - delta.y);
                if ((unsigned)q.x >= (unsigned)im.cols || (unsigned)q.y >= (unsigned)im.rows) throw CvError();
                const uint8_t value = im.at(q.y, q.x);
                temp = locs[i];
                remote = value == 0 ? P2i(temp.x - delta.x, temp.y - delta.y) : P2i(temp.x - half.x, temp.y - half.y);
            }
        }
        size_t tx = 0, ty = 0;
        uint8_t future = 255;
        if (remote.y >= 0 && remote.y < im.rows)
            for (int i = std::max(remote.x, 0); i < im.cols; i++)
                if (im.at(remote.y, i) == future) {
                    future = (uint8_t)~future;
                    tx++;
                }
        future = 255;
        // OpenCV reads Point(j, remote.x): row remote.x, column j
        if (remote.x >= 0 && remote.x < im.rows)
            for (int j = std::max(remote.y, 0); j < im.rows; j++)
                if (j < im.cols && im.at(remote.x, j) == future) {
                    future = (uint8_t)~future;
                    ty++;
                }
        const size_t mn = std::min(tx, ty);
        const double vt_d = (double)(size_t)(mn - 1) * 0.25 - 1.0;
        int vt_i = cv_round(vt_d);
        const int vt = vt_i < 0 ? 0 : (vt_i > 255 ? 255 : vt_i);
        const double F = modules_by_finders();
        const double vf_d = (F - 21.0) * 0.25 + 1.0;
        const int vf = cv_round(vf_d);
        int v = vt;
        if (vf <= 0) {
            if (vt > 6) {
                auto bc = version_by_code(vt, 4.0 * vt + 17);
                if (5.0 > bc.first) v = bc.second;
            }
        } else {
            bool use_finder = false;
            if (6.0 >= vf_d && tx != ty) {
                double err = std::fabs(F - (double)cv_round(F));
                use_finder = 0.2 > err;
            }
            if (vt > 6 || vf > 6) {
                std::vector<std::pair<double, int>> cands;
                if (vf > 6) cands.push_back(version_by_code(vf, F));
                if (vt > 6) cands.push_back(version_by_code(vt, 4.0 * vt + 17));
                std::pair<double, int> best = std::min(cands.front(), cands.back());
                if (5.0 > best.first)
                    v = best.second;
                else if (use_finder)
                    v = (uint8_t)vf;
            } else if (use_finder) {
                v = (uint8_t)vf;
            }
        }
        version = (uint8_t)v;
        version_size = (uint8_t)(21 + (version - 1) * 4);
        return 0 < version && version <= 40;
    }

    void detect_alignment() {
        if (version <= 1) return;
        std::vector<int> pos = alignment_centres(version);
        const int L = pos.back();
        std::vector<P2i> centres;
        if (version <= 6) {
            centres.push_back(P2i(L, L));
        } else {
            const int P = pos[pos.size() - 2], p1 = pos[1];
            centres = {P2i(L, L), P2i(L, P), P2i(P, L), P2i(P, P), P2i(pos[0], p1), P2i(p1, pos[0])};
        }
        std::vector<P2f> persp = {P2f(0.f, 0.f), P2f(tps, 0.f), P2f(0.f, tps)};
        std::vector<P2f> obj = {original_points[0], original_points[1], original_points[3]};
        static const uint8_t kMarker[25] = {0, 0, 0, 0, 0, 0, 255, 255, 255, 0, 0, 255, 0,
                                            255, 0, 0, 255, 255, 255, 0, 0, 0, 0, 0, 0};
        Img marker(5, 5);
        std::memcpy(marker.d.data(), kMarker, 25);
        const float ms = tps / (float)version_size;
        const int msize = cvt_round_f(ms * 5.f);
        Img resized = resize_area(marker, msize, msize);
        const int offset = cvt_round_f(ms * 8.8f);
        for (const P2i& c : centres) {
            const float x0 = ((float)c.x - 2.f - 1.9f) * ms, y0 = ((float)c.y - 2.f - 1.9f) * ms;
            const int rx = cvt_round_f(x0), ry = cvt_round_f(y0);
            if (rx < 0 || ry < 0 || rx + offset > no_border.cols || ry + offset > no_border.rows) throw CvError();
            Img win = crop(no_border, ry, ry + offset, rx, rx + offset);
            if (win.rows < resized.rows || win.cols < resized.cols) throw CvError();
            double max_val;
            P2i loc;
            match_template_max(win, resized, max_val, loc);
            if (max_val > 0.65) {
                const float half = (float)resized.cols * 0.5f;
                alignment_coords.push_back(P2f((float)loc.x + x0 + half, (float)loc.y + y0 + half));
                M33 inv;
                if (!invert33(homography, inv)) inv = M33{};
                perspective_transform(alignment_coords, inv);
                persp.push_back(P2f(((float)c.x + 0.5f) / (float)version_size * tps,
                                    ((float)c.y + 0.5f) / (float)version_size * tps));
                obj.push_back(alignment_coords.back());
            }
        }
        if (obj.size() <= 3) return;
        double thresh = 10.0;
        if (version == 2) {
            obj.push_back(original_points[2]);
            persp.push_back(P2f(tps, tps));
            thresh = 5.0;
        }
        M33 H;
        if (!find_homography_ransac(obj, persp, thresh, H)) return;
        update_perspective(H);
        std::vector<P2f> corner = {P2f(tps, tps)};
        M33 inv;
        if (!invert33(homography, inv)) inv = M33{};
        perspective_transform(corner, inv);
        original_points[2] = corner[0];
    }

    void sampling_for_version() {
        const double factor = version < 3 ? 1.0 : (version == 3 ? 2.0 : 3.0);
        const int nw = cv_round(no_border.cols * factor), nh = cv_round(no_border.rows * factor);
        Img post = resize_area(no_border, nw, nh);
        const int vs = version_size;
        const int delta_rows = cv_round(post.rows * 1.0 / vs), delta_cols = cv_round(post.cols * 1.0 / vs);
        const int skipped_rows = post.rows - delta_rows * vs, skipped_cols = post.cols - delta_cols * vs;
        std::vector<int> dr(vs, delta_rows), dc(vs, delta_cols);
        if (skipped_rows) {
            const int n = std::abs(skipped_rows);
            const double step = (double)vs / n, halfstep = 0.5 * step;
            for (int i = 0; i < n; i++) dr[(int)(i * step + halfstep)] += skipped_rows > 0 ? 1 : -1;
        }
        if (skipped_cols) {
            const int n = std::abs(skipped_cols);
            const double step = (double)vs / n, halfstep = 0.5 * step;
            for (int i = 0; i < n; i++) dc[(int)(i * step + halfstep)] += skipped_cols > 0 ? 1 : -1;
        }
        int64_t nz = 0;
        for (uint8_t v : post.d) nz += v != 0;
        const double total = (double)nz / (double)post.d.size();
        straight = Img(vs, vs, 0);
        for (int r = 0, i = 0; i < vs; r += dr[i], i++) {
            const int r1 = std::min(r + delta_rows, post.rows);
            for (int c = 0, j = 0; j < vs; c += dc[j], j++) {
                const int c1 = std::min(c + delta_cols, post.cols);
                if (r1 < r || c1 < c) throw CvError();
                int64_t cnt = 0;
                for (int y = r; y < r1; y++)
                    for (int x = c; x < c1; x++) cnt += post.at(y, x) != 0;
                const double freq = (double)cnt / (double)((int64_t)(r1 - r) * (c1 - c));
                straight.at(i, j) = total > freq ? 0 : 255;
            }
        }
    }

    bool straight_decoding_process() {
        std::vector<P2f> persp = {P2f(0.f, 0.f), P2f(tps, 0.f), P2f(tps, tps), P2f(0.f, tps)};
        M33 H;
        if (!homography_kernel(original_points, persp, H)) return false;
        update_perspective(H);
        if (!version_definition()) return false;
        if (use_alignment) detect_alignment();
        sampling_for_version();
        return decoding_process();
    }

    static bool ascii(const std::string& s) {
        for (unsigned char c : s)
            if (c & 0x80) return false;
        return true;
    }

    static bool utf8(const std::string& s) {
        const size_t n = s.size();
        for (size_t i = 0; i < n; i++) {
            const unsigned char c = s[i];
            if (c < 0x80) continue;
            size_t k;
            if ((c & 0xe0) == 0xc0) k = 2;
            else if ((c & 0xf0) == 0xe0) k = 3;
            else if ((c & 0xf8) == 0xf0) k = 4;
            else return false;
            for (size_t j = 1; j < k; j++)
                if (i + j >= n || ((unsigned char)s[i + j] & 0xc0) != 0x80) return false;
            i += k - 1;
        }
        return true;
    }

    bool decoding_process() {
        if (!dec.decode(straight, result)) return false;
        mode = dec.mode;
        parity = dec.parity;
        sequence_num = dec.sequence_num;
        total_num = dec.total_num;
        switch (dec.mode) {
            case 1:
            case 2: return ascii(result);
            case 3: return true;
            case 8: dec.eci = 20; return true;
            case 7: return true;
            case 4:
                if (dec.eci == 26) return utf8(result);
                if (dec.eci == 25) return false;
                if (ascii(result) || utf8(result)) return true;
                {
                    std::string o;
                    for (unsigned char c : result) {
                        if (c >= 0x80) {
                            o += (char)(0xc0 | (c >> 6));
                            o += (char)(0x80 | (c & 0x3f));
                        } else {
                            o += (char)c;
                        }
                    }
                    result = o;
                }
                return true;
            default: return false;
        }
    }
};

// ------------------------------------------------------------ the calls

struct Decoded {
    bool ok = false;
    std::string text;
    int mode = -1;
    uint8_t seq = 0, total = 1, parity = 0;
    Img straight;
};

bool quad_area_positive(const std::vector<P2f>& q) { return contour_area(q) > 0.0; }

// ImplContour::decode on one quad (the caller checks the image and area);
// ``qd`` keeps the fields a later decode on the same object starts from
Decoded decode_quad(const Img& gray, const std::vector<P2f>& quad, bool use_alignment, QRDecode& qd) {
    qd.use_alignment = use_alignment;
    qd.init(gray, quad);
    Decoded d;
    d.ok = qd.straight_decoding_process();
    d.text = d.ok ? qd.result : std::string();
    d.mode = qd.mode;
    d.seq = qd.sequence_num;
    d.total = qd.total_num;
    d.parity = qd.parity;
    if (d.ok) d.straight = qd.straight;
    return d;
}

Decoded decode_quad(const Img& gray, const std::vector<P2f>& quad, bool use_alignment) {
    QRDecode qd;
    return decode_quad(gray, quad, use_alignment, qd);
}

// ParallelDecodeProcess on one quad: where it fails on a frame whose
// shorter side exceeds 512, again (the same QRDecode) on the INTER_AREA
// shrink to 512
Decoded decode_quad_multi(const Img& gray, std::vector<P2f> quad, bool use_alignment) {
    QRDecode qd;
    Decoded d = decode_quad(gray, quad, use_alignment, qd);
    if (d.ok) return d;
    const int mn = std::min(gray.cols, gray.rows);
    if (mn > 512) {
        const float coeff = (float)mn * 0.001953125f;
        const int w = cvt_round_f((float)gray.cols / coeff), h = cvt_round_f((float)gray.rows / coeff);
        Img small = resize_area(gray, w, h);
        for (P2f& p : quad) p = P2f(p.x / coeff, p.y / coeff);
        d = decode_quad(small, quad, use_alignment, qd);
        if (!d.ok) d.text.clear();
    }
    return d;
}

// decodeMulti's structured append: a part with sequence number 0 takes the
// parts 1 .. total-1 (the first code of the same parity and number, in
// order), appended, or "" where one is missing; the other parts read ""
std::vector<std::string> join_structured(const std::vector<Decoded>& res) {
    std::vector<std::string> out(res.size());
    for (size_t i = 0; i < res.size(); i++) {
        const Decoded& d = res[i];
        if (d.mode != 3) {
            out[i] = d.ok ? d.text : std::string();
            continue;
        }
        if (d.seq != 0) continue;
        std::string s = d.ok ? d.text : std::string();
        for (size_t k = 1; k < d.total; k++) {
            size_t j = 0;
            while (j < res.size() && !(res[j].parity == d.parity && res[j].seq == k)) j++;
            if (j == res.size()) {
                s.clear();
                break;
            }
            s += res[j].ok ? res[j].text : std::string();
        }
        out[i] = s;
    }
    return out;
}

int put_text(const std::string& s, uint8_t* out, int64_t cap, int64_t& used) {
    if (used + (int64_t)s.size() > cap) return -1;
    std::memcpy(out + used, s.data(), s.size());
    used += (int64_t)s.size();
    return 0;
}

}  // namespace

extern "C" {

// findHomography(src, dst) of 4 float point pairs (method 0): → 1 and the
// matrix in ``H`` (9 doubles), or 0 where it finds none
int qr_dec_homography(const float* src, const float* dst, int n, int ransac, double thresh, double* H) {
    std::vector<P2f> a, b;
    for (int i = 0; i < n; i++) {
        a.push_back(P2f(src[2 * i], src[2 * i + 1]));
        b.push_back(P2f(dst[2 * i], dst[2 * i + 1]));
    }
    M33 h;
    bool ok = ransac ? find_homography_ransac(a, b, thresh, h) : (n == 4 && homography_kernel(a, b, h));
    if (!ok) return 0;
    for (int i = 0; i < 9; i++) H[i] = h[i];
    return 1;
}

// warpPerspective(src, H, (w, h), INTER_NEAREST, BORDER_CONSTANT, 0)
int qr_dec_warp_nearest(const uint8_t* src, int rows, int cols, const double* H, int w, int h, uint8_t* out) {
    M33 m;
    for (int i = 0; i < 9; i++) m[i] = H[i];
    Img o;
    if (!warp_perspective_nearest(wrap(src, rows, cols), m, w, h, o)) return 0;
    std::memcpy(out, o.d.data(), o.d.size());
    return 1;
}

// resize(src, (w, h), INTER_AREA) on uint8
void qr_dec_resize_area(const uint8_t* src, int rows, int cols, int w, int h, uint8_t* out) {
    Img o = resize_area(wrap(src, rows, cols), w, h);
    std::memcpy(out, o.d.data(), o.d.size());
}

// matchTemplate(img, templ, TM_CCOEFF_NORMED) → its maximum and location
double qr_dec_match_template(const uint8_t* img, int rows, int cols, const uint8_t* tpl, int trows, int tcols,
                             int* loc) {
    double v;
    P2i p;
    match_template_max(wrap(img, rows, cols), wrap(tpl, trows, tcols), v, p);
    loc[0] = p.x;
    loc[1] = p.y;
    return v;
}

// perspectiveTransform of float points by a double 3x3 matrix, in place
void qr_dec_perspective_transform(float* pts, int n, const double* H) {
    M33 m;
    for (int i = 0; i < 9; i++) m[i] = H[i];
    std::vector<P2f> p;
    for (int i = 0; i < n; i++) p.push_back(P2f(pts[2 * i], pts[2 * i + 1]));
    perspective_transform(p, m);
    for (int i = 0; i < n; i++) pts[2 * i] = p[i].x, pts[2 * i + 1] = p[i].y;
}

// decode(gray, quad, straight): the payload of one quad (the caller holds
// the image past 20 pixels a side). → its length (>= 0), -1 where the decode
// fails, -2 where OpenCV raises, -3 where ``out`` is too small. ``grid``
// receives the straight code (side in ``side``) when it decodes.
int64_t qr_decode_quad(const uint8_t* gray, int rows, int cols, const float* quad, int use_alignment, uint8_t* out,
                       int64_t cap, uint8_t* grid, int* side) {
    try {
        Img img = wrap(gray, rows, cols);
        std::vector<P2f> q;
        for (int j = 0; j < 4; j++) q.push_back(P2f(quad[2 * j], quad[2 * j + 1]));
        if (!quad_area_positive(q)) return -2;  // CV_CheckGT(contourArea(points), 0)
        Decoded d = decode_quad(img, q, use_alignment != 0);
        *side = 0;
        if (!d.ok) return -1;
        if ((int64_t)d.text.size() > cap) return -3;
        std::memcpy(out, d.text.data(), d.text.size());
        if (grid) {
            *side = d.straight.rows;
            std::memcpy(grid, d.straight.d.data(), d.straight.d.size());
        }
        return (int64_t)d.text.size();
    } catch (const CvError&) {
        return -2;
    }
}

// cv2.QRCodeDetector().detectAndDecode(gray): → the payload's length (0
// where nothing decodes), -2 where OpenCV raises, -3 where ``out`` is too
// small
int64_t qr_detect_and_decode(const uint8_t* gray, int rows, int cols, const uint8_t* resized, int rrows, int rcols,
                             uint8_t* out, int64_t cap) {
    float quad[8];
    if (!qr_detect(gray, rows, cols, resized, rrows, rcols, quad)) return 0;
    try {
        Img img = wrap(gray, rows, cols);
        std::vector<P2f> q;
        for (int j = 0; j < 4; j++) q.push_back(P2f(quad[2 * j], quad[2 * j + 1]));
        if (!quad_area_positive(q)) return -2;
        Decoded d = decode_quad(img, q, true);
        if (!d.ok) return 0;
        if ((int64_t)d.text.size() > cap) return -3;
        std::memcpy(out, d.text.data(), d.text.size());
        return (int64_t)d.text.size();
    } catch (const CvError&) {
        return -2;
    }
}

// cv2.QRCodeDetector().detectAndDecodeMulti(gray): → the number of codes
// (their payloads concatenated in ``out``, each one's length in ``lens``,
// 0 for a code that does not decode), 0 where detectMulti finds none (cv2's
// ok False), -2 where OpenCV raises, -3 where a buffer is too small
int64_t qr_detect_and_decode_multi(const uint8_t* gray, int rows, int cols, const uint8_t* resized, int rrows,
                                   int rcols, uint8_t* out, int64_t cap, int64_t* lens, int max_codes) {
    std::vector<float> quads((size_t)max_codes * 8);
    int n = qr_detect_multi(gray, rows, cols, resized, rrows, rcols, quads.data(), max_codes);
    if (n <= 0) return 0;
    try {
        Img img = wrap(gray, rows, cols);
        std::vector<std::vector<P2f>> src;
        for (int i = 0; i < n; i++) {
            std::vector<P2f> q;
            for (int j = 0; j < 4; j++) q.push_back(P2f(quads[8 * i + 2 * j], quads[8 * i + 2 * j + 1]));
            if (quad_area_positive(q)) src.push_back(q);
        }
        if (src.empty()) return -2;  // CV_Assert(src_points.size() > 0)
        std::vector<Decoded> res;
        for (auto& q : src) res.push_back(decode_quad_multi(img, q, true));
        std::vector<std::string> texts = join_structured(res);
        int64_t used = 0;
        for (size_t i = 0; i < texts.size(); i++) {
            if (put_text(texts[i], out, cap, used)) return -3;
            lens[i] = (int64_t)texts[i].size();
        }
        return (int64_t)texts.size();
    } catch (const CvError&) {
        return -2;
    }
}

}  // extern "C"
