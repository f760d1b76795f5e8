// OpenCV's DFT path of ``cv::filter2D`` for the host CPU: ``dftFilter2D`` ->
// ``crossCorr`` (imgproc) on the mixed-radix DFT of ``dxt.cpp`` (core), in
// double precision, rounding as OpenCV 5.0 rounds with IPP off.
//
// Plain C interface, called through ctypes by ``ops/host_filter.py``; built
// with the host C++ compiler (``_build.build_host``), not with nvcc.
//
// - ``crossCorr`` computes in CV_64F for every image depth above CV_8S, so a
//   float32 image is filtered in double and rounded once at the end. The
//   image is cut into tiles of ``getOptimalDFTSize`` blocks, each tile padded
//   ``BORDER_REFLECT_101`` at the image's edges, and per tile and channel:
//   the real 2-D forward DFT (CCS packing), ``mulSpectrums`` with the
//   conjugate of the kernel's spectrum, and the inverse DFT with
//   ``DFT_SCALE``.
// - The 2-D real DFT is ``OcvDftImpl``'s: ``RealDFT`` on each row, then the
//   complex DFT of each column (the first and, at an even width, the last
//   column as complex vectors with zero imaginary parts); the inverse runs
//   the columns first (``ExpandCCS``) and ``CCSIDFT`` on the rows.
// - The complex DFT is ``DFT<double>``: the power-of-two factor as radix-4
//   stages then a radix-2 one, then radix 3, 5 and a generic odd radix; the
//   twiddle table ``DFTInit`` builds by repeated complex products in double
//   from ``cos/sin(2π/n)``.
//
// ``dxt.cpp``, ``templmatch.cpp`` and ``filter.dispatch.cpp`` are compiled at
// OpenCV's SSE3 baseline (they have no AVX2 dispatch), so none of their
// multiply-adds is fused: every product and sum below rounds on its own, and
// the pragmas keep the compiler from contracting any of them.

#pragma STDC FP_CONTRACT OFF
#if defined(__GNUC__) && !defined(__clang__)
#pragma GCC optimize("fp-contract=off")
#endif

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

struct Cx {
    double re, im;
};

// cos and sin of 2π/2^m as OpenCV's DFTTab lists them (its sines from 2^7
// on are not the C library's), to 2^9: crossCorr's blocks are at most 256
// points a side for the kernels filter2d_f32 takes, and cv2.dft's results
// hold these rows to 512.
const double kDftTab[][2] = {
    {1.00000000000000000, 0.00000000000000000},
    {-1.00000000000000000, 0.00000000000000000},
    {0.00000000000000000, 1.00000000000000000},
    {0.70710678118654757, 0.70710678118654746},
    {0.92387953251128674, 0.38268343236508978},
    {0.98078528040323043, 0.19509032201612825},
    {0.99518472667219693, 0.09801714032956060},
    {0.99879545620517241, 0.04906767432741802},
    {0.99969881869620425, 0.02454122852291229},
    {0.99992470183914450, 0.01227153828571993},
};
const int kMaxPow2 = 1 << 9;

// DFTFactorize: the power-of-two part first (one factor), then the odd
// prime factors; the odd ones are reversed.
int factorize(int n, int *factors) {
    int nf = 0;
    if (n <= 5) {
        factors[0] = n;
        return 1;
    }
    int f = (((n - 1) ^ n) + 1) >> 1;
    if (f > 1) {
        factors[nf++] = f;
        n = f == n ? 1 : n / f;
    }
    for (f = 3; n > 1;) {
        int d = n / f;
        if (d * f == n) {
            factors[nf++] = f;
            n = d;
        } else {
            f += 2;
            if (f * f > n) break;
        }
    }
    if (n > 1) factors[nf++] = n;
    f = (factors[0] & 1) == 0;
    for (int i = f; i < (nf + f) / 2; i++) {
        int t = factors[i];
        factors[i] = factors[nf - i - 1 + f];
        factors[nf - i - 1 + f] = t;
    }
    return nf;
}

int bitrev(int x, int bits) {
    int r = 0;
    for (int b = 0; b < bits; b++) r |= ((x >> b) & 1) << (bits - 1 - b);
    return r;
}

// One length's tables (DFTInit): the digit-reversal permutation and the
// twiddles w^k, w = exp(-2πi/n).
struct Plan {
    int n = 0, nf = 0;
    int factors[34];
    std::vector<int> itab, inv_itab;
    std::vector<Cx> wave;

    explicit Plan(int n0) : n(n0) {
        nf = factorize(n0, factors);
        itab.resize(n0);
        wave.resize(n0);
        // itab[i] for i = d0 + f0·(d1 + f1·(d2 + ...)) is the digits
        // reversed, the first digit bit-reversed when f0 is a power of two
        long radix[35];
        radix[nf] = 1;
        for (int i = nf - 1; i >= 0; i--) radix[i] = radix[i + 1] * factors[i];
        int f0 = factors[0], m0 = 0;
        bool pow2 = (f0 & (f0 - 1)) == 0;
        while ((1 << m0) < f0) m0++;
        for (int i = 0; i < n0; i++) {
            int rest = i, j = 0;
            for (int k = 0; k < nf; k++) {
                int d = rest % factors[k];
                rest /= factors[k];
                if (k == 0 && pow2) d = bitrev(d, m0);
                j += d * (int)radix[k + 1];
            }
            itab[i] = j;
        }
        inv_itab.resize(n0);
        for (int i = 0; i < n0; i++) inv_itab[itab[i]] = i;
        Cx w, w1;
        if ((n0 & (n0 - 1)) == 0) {
            int m = 0;
            while ((1 << m) < n0) m++;
            w.re = w1.re = kDftTab[m][0];
            w.im = w1.im = -kDftTab[m][1];
        } else {
            double t = -M_PI * 2 / n0;
            w.im = w1.im = std::sin(t);
            w.re = w1.re = std::sqrt(1. - w1.im * w1.im);
        }
        int n = (n0 + 1) / 2;
        wave[0].re = 1.;
        wave[0].im = 0.;
        if ((n0 & 1) == 0) {
            wave[n].re = -1.;
            wave[n].im = 0;
        }
        for (int i = 1; i < n; i++) {
            wave[i] = w;
            wave[n0 - i].re = w.re;
            wave[n0 - i].im = -w.im;
            double t = w.re * w1.re - w.im * w1.im;
            w.im = w.re * w1.im + w.im * w1.re;
            w.re = t;
        }
    }
};

// One call of DFT<double>: length n, the factors used, the tables of the
// length tab_size they come from (tab_size = n, or 2n for RealDFT's half).
struct Opts {
    int n;
    int nf;
    const int *factors;
    const Plan *plan;
    bool inv;
    bool no_permute;
    double scale;
};

const double kSin120 = 0.86602540378443864676372317075294;
const double kFft5_2 = 0.559016994374947424102293417182819;
const double kFft5_3 = -0.951056516295153572116439333379382;
const double kFft5_4 = -1.538841768587626701285145288018455;
const double kFft5_5 = 0.363271264002680442947733378740309;

// DFT<double>: src and dst may be the same array only with no_permute.
void dft(const Opts &c, const Cx *src, Cx *dst) {
    const Cx *wave = c.plan->wave.data();
    const int tab_size = c.plan->n;
    const int *itab = c.plan->itab.data();
    int n = c.n, nx, dw, dw0 = tab_size;
    int tab_step = tab_size == n ? 1 : tab_size == n * 2 ? 2 : tab_size / n;

    // 0. shuffle (the inverse conjugates its input)
    if (!c.no_permute) {
        for (int i = 0; i < n; i++) {
            Cx t = src[itab[i * tab_step]];
            if (c.inv) t.im = -t.im;
            dst[i] = t;
        }
    } else {
        if (dst != src) std::memcpy(dst, src, sizeof(Cx) * n);
        if (c.inv)
            for (int i = 0; i < n; i++) dst[i].im = -dst[i].im;
    }

    n = 1;
    // 1. the power-of-two factor: radix 4, then radix 2
    if ((c.factors[0] & 1) == 0) {
        for (; n * 4 <= c.factors[0];) {
            nx = n;
            n *= 4;
            dw0 /= 4;
            for (int i = 0; i < c.n; i += n) {
                Cx *v0 = dst + i, *v1 = v0 + nx * 2;
                double r0, i0, r1, i1, r2, i2, r3, i3, r4, i4;
                r0 = v1[0].re; i0 = v1[0].im;
                r4 = v1[nx].re; i4 = v1[nx].im;
                r1 = r0 + r4; i1 = i0 + i4;
                r3 = i0 - i4; i3 = r4 - r0;
                r2 = v0[0].re; i2 = v0[0].im;
                r4 = v0[nx].re; i4 = v0[nx].im;
                r0 = r2 + r4; i0 = i2 + i4;
                r2 -= r4; i2 -= i4;
                v0[0].re = r0 + r1; v0[0].im = i0 + i1;
                v1[0].re = r0 - r1; v1[0].im = i0 - i1;
                v0[nx].re = r2 + r3; v0[nx].im = i2 + i3;
                v1[nx].re = r2 - r3; v1[nx].im = i2 - i3;
                int j;
                for (j = 1, dw = dw0; j < nx; j++, dw += dw0) {
                    v0 = dst + i + j;
                    v1 = v0 + nx * 2;
                    r2 = v0[nx].re * wave[dw * 2].re - v0[nx].im * wave[dw * 2].im;
                    i2 = v0[nx].re * wave[dw * 2].im + v0[nx].im * wave[dw * 2].re;
                    r0 = v1[0].re * wave[dw].im + v1[0].im * wave[dw].re;
                    i0 = v1[0].re * wave[dw].re - v1[0].im * wave[dw].im;
                    r3 = v1[nx].re * wave[dw * 3].im + v1[nx].im * wave[dw * 3].re;
                    i3 = v1[nx].re * wave[dw * 3].re - v1[nx].im * wave[dw * 3].im;
                    r1 = i0 + i3; i1 = r0 + r3;
                    r3 = r0 - r3; i3 = i3 - i0;
                    r4 = v0[0].re; i4 = v0[0].im;
                    r0 = r4 + r2; i0 = i4 + i2;
                    r2 = r4 - r2; i2 = i4 - i2;
                    v0[0].re = r0 + r1; v0[0].im = i0 + i1;
                    v1[0].re = r0 - r1; v1[0].im = i0 - i1;
                    v0[nx].re = r2 + r3; v0[nx].im = i2 + i3;
                    v1[nx].re = r2 - r3; v1[nx].im = i2 - i3;
                }
            }
        }
        for (; n < c.factors[0];) {
            nx = n;
            n *= 2;
            dw0 /= 2;
            for (int i = 0; i < c.n; i += n) {
                Cx *v = dst + i;
                double r0 = v[0].re + v[nx].re;
                double i0 = v[0].im + v[nx].im;
                double r1 = v[0].re - v[nx].re;
                double i1 = v[0].im - v[nx].im;
                v[0].re = r0; v[0].im = i0;
                v[nx].re = r1; v[nx].im = i1;
                int j;
                for (j = 1, dw = dw0; j < nx; j++, dw += dw0) {
                    v = dst + i + j;
                    r1 = v[nx].re * wave[dw].re - v[nx].im * wave[dw].im;
                    i1 = v[nx].im * wave[dw].re + v[nx].re * wave[dw].im;
                    r0 = v[0].re; i0 = v[0].im;
                    v[0].re = r0 + r1; v[0].im = i0 + i1;
                    v[nx].re = r0 - r1; v[nx].im = i0 - i1;
                }
            }
        }
    }

    // 2. the odd factors
    for (int f_idx = (c.factors[0] & 1) ? 0 : 1; f_idx < c.nf; f_idx++) {
        int factor = c.factors[f_idx];
        nx = n;
        n *= factor;
        dw0 /= factor;
        if (factor == 3) {
            for (int i = 0; i < c.n; i += n) {
                Cx *v = dst + i;
                double r1 = v[nx].re + v[nx * 2].re;
                double i1 = v[nx].im + v[nx * 2].im;
                double r0 = v[0].re;
                double i0 = v[0].im;
                double r2 = kSin120 * (v[nx].im - v[nx * 2].im);
                double i2 = kSin120 * (v[nx * 2].re - v[nx].re);
                v[0].re = r0 + r1; v[0].im = i0 + i1;
                r0 -= 0.5 * r1; i0 -= 0.5 * i1;
                v[nx].re = r0 + r2; v[nx].im = i0 + i2;
                v[nx * 2].re = r0 - r2; v[nx * 2].im = i0 - i2;
                int j;
                for (j = 1, dw = dw0; j < nx; j++, dw += dw0) {
                    v = dst + i + j;
                    r0 = v[nx].re * wave[dw].re - v[nx].im * wave[dw].im;
                    i0 = v[nx].re * wave[dw].im + v[nx].im * wave[dw].re;
                    i2 = v[nx * 2].re * wave[dw * 2].re - v[nx * 2].im * wave[dw * 2].im;
                    r2 = v[nx * 2].re * wave[dw * 2].im + v[nx * 2].im * wave[dw * 2].re;
                    r1 = r0 + i2; i1 = i0 + r2;
                    r2 = kSin120 * (i0 - r2); i2 = kSin120 * (i2 - r0);
                    r0 = v[0].re; i0 = v[0].im;
                    v[0].re = r0 + r1; v[0].im = i0 + i1;
                    r0 -= 0.5 * r1; i0 -= 0.5 * i1;
                    v[nx].re = r0 + r2; v[nx].im = i0 + i2;
                    v[nx * 2].re = r0 - r2; v[nx * 2].im = i0 - i2;
                }
            }
        } else if (factor == 5) {
            for (int i = 0; i < c.n; i += n) {
                int j;
                for (j = 0, dw = 0; j < nx; j++, dw += dw0) {
                    Cx *v0 = dst + i + j, *v1 = v0 + nx * 2, *v2 = v1 + nx * 2;
                    double r0, i0, r1, i1, r2, i2, r3, i3, r4, i4, r5, i5;
                    r3 = v0[nx].re * wave[dw].re - v0[nx].im * wave[dw].im;
                    i3 = v0[nx].re * wave[dw].im + v0[nx].im * wave[dw].re;
                    r2 = v2[0].re * wave[dw * 4].re - v2[0].im * wave[dw * 4].im;
                    i2 = v2[0].re * wave[dw * 4].im + v2[0].im * wave[dw * 4].re;
                    r1 = r3 + r2; i1 = i3 + i2;
                    r3 -= r2; i3 -= i2;
                    r4 = v1[nx].re * wave[dw * 3].re - v1[nx].im * wave[dw * 3].im;
                    i4 = v1[nx].re * wave[dw * 3].im + v1[nx].im * wave[dw * 3].re;
                    r0 = v1[0].re * wave[dw * 2].re - v1[0].im * wave[dw * 2].im;
                    i0 = v1[0].re * wave[dw * 2].im + v1[0].im * wave[dw * 2].re;
                    r2 = r4 + r0; i2 = i4 + i0;
                    r4 -= r0; i4 -= i0;
                    r0 = v0[0].re; i0 = v0[0].im;
                    r5 = r1 + r2; i5 = i1 + i2;
                    v0[0].re = r0 + r5; v0[0].im = i0 + i5;
                    r0 -= 0.25 * r5; i0 -= 0.25 * i5;
                    r1 = kFft5_2 * (r1 - r2); i1 = kFft5_2 * (i1 - i2);
                    r2 = -kFft5_3 * (i3 + i4); i2 = kFft5_3 * (r3 + r4);
                    i3 *= -kFft5_5; r3 *= kFft5_5;
                    i4 *= -kFft5_4; r4 *= kFft5_4;
                    r5 = r2 + i3; i5 = i2 + r3;
                    r2 -= i4; i2 -= r4;
                    r3 = r0 + r1; i3 = i0 + i1;
                    r0 -= r1; i0 -= i1;
                    v0[nx].re = r3 + r2; v0[nx].im = i3 + i2;
                    v2[0].re = r3 - r2; v2[0].im = i3 - i2;
                    v1[0].re = r0 + r5; v1[0].im = i0 + i5;
                    v1[nx].re = r0 - r5; v1[nx].im = i0 - i5;
                }
            }
        } else {
            // a generic odd radix
            int factor2 = (factor - 1) / 2, dw_f = tab_size / factor;
            std::vector<Cx> buf(factor2 * 2);
            Cx *a = buf.data(), *b = a + factor2;
            for (int i = 0; i < c.n; i += n) {
                int j;
                for (j = 0, dw = 0; j < nx; j++, dw += dw0) {
                    Cx *v = dst + i + j;
                    Cx v_0 = v[0], vn_0 = v_0;
                    int p, k;
                    if (j == 0) {
                        for (p = 1, k = nx; p <= factor2; p++, k += nx) {
                            double r0 = v[k].re + v[n - k].re;
                            double i0 = v[k].im - v[n - k].im;
                            double r1 = v[k].re - v[n - k].re;
                            double i1 = v[k].im + v[n - k].im;
                            vn_0.re += r0; vn_0.im += i1;
                            a[p - 1].re = r0; a[p - 1].im = i0;
                            b[p - 1].re = r1; b[p - 1].im = i1;
                        }
                    } else {
                        const Cx *wave_ = wave + dw * factor;
                        int d = dw;
                        for (p = 1, k = nx; p <= factor2; p++, k += nx, d += dw) {
                            double r2 = v[k].re * wave[d].re - v[k].im * wave[d].im;
                            double i2 = v[k].re * wave[d].im + v[k].im * wave[d].re;
                            double r1 = v[n - k].re * wave_[-d].re - v[n - k].im * wave_[-d].im;
                            double i1 = v[n - k].re * wave_[-d].im + v[n - k].im * wave_[-d].re;
                            double r0 = r2 + r1;
                            double i0 = i2 - i1;
                            r1 = r2 - r1;
                            i1 = i2 + i1;
                            vn_0.re += r0; vn_0.im += i1;
                            a[p - 1].re = r0; a[p - 1].im = i0;
                            b[p - 1].re = r1; b[p - 1].im = i1;
                        }
                    }
                    v[0] = vn_0;
                    for (p = 1, k = nx; p <= factor2; p++, k += nx) {
                        Cx s0 = v_0, s1 = v_0;
                        int d = dw_f * p, dd = d;
                        for (int q = 0; q < factor2; q++) {
                            double r0 = wave[d].re * a[q].re;
                            double i0 = wave[d].im * a[q].im;
                            double r1 = wave[d].re * b[q].im;
                            double i1 = wave[d].im * b[q].re;
                            s1.re += r0 + i0; s0.re += r0 - i0;
                            s1.im += r1 - i1; s0.im += r1 + i1;
                            d += dd;
                            d -= -(d >= tab_size) & tab_size;
                        }
                        v[k] = s0;
                        v[n - k] = s1;
                    }
                }
            }
        }
    }

    if (c.scale != 1) {
        double re_scale = c.scale, im_scale = c.scale;
        if (c.inv) im_scale = -im_scale;
        for (int i = 0; i < c.n; i++) {
            double t0 = dst[i].re * re_scale;
            double t1 = dst[i].im * im_scale;
            dst[i].re = t0;
            dst[i].im = t1;
        }
    } else if (c.inv) {
        for (int i = 0; i < c.n; i++) dst[i].im = -dst[i].im;
    }
}

Opts whole(const Plan &p, bool inv, double scale) {
    return Opts{p.n, p.nf, p.factors, &p, inv, false, scale};
}

// RealDFT (CCS output, no complex output): src of n reals -> dst of n reals
// [Re0, Re1, Im1, ...]. tmp holds 2n doubles.
void real_dft(const Plan &p, const double *src, double *dst, Cx *tmp) {
    int n = p.n;
    if (n == 1) {
        dst[0] = src[0];
    } else if (n == 2) {
        double t = src[0] + src[1];
        dst[1] = src[0] - src[1];
        dst[0] = t;
    } else if (n & 1) {
        tmp[0].re = src[0];
        tmp[0].im = 0;
        for (int j = 1; j < n; j += 2) {
            tmp[j].re = src[p.itab[j]];
            tmp[j].im = 0;
            tmp[j + 1].re = src[p.itab[j + 1]];
            tmp[j + 1].im = 0;
        }
        Opts c = whole(p, false, 1.);
        c.no_permute = true;
        dft(c, tmp, tmp);
        const double *t = reinterpret_cast<const double *>(tmp);
        dst[0] = t[0];
        std::memcpy(dst + 1, t + 2, sizeof(double) * (n - 1));
    } else {
        int n2 = n >> 1;
        int sub[34];
        std::memcpy(sub, p.factors, sizeof(int) * p.nf);
        sub[0] >>= 1;
        Opts c{n2, p.nf - (sub[0] == 1), sub + (sub[0] == 1), &p, false, false, 1.};
        dft(c, reinterpret_cast<const Cx *>(src), tmp);
        double *d = reinterpret_cast<double *>(tmp);
        double t = d[0] - d[1];
        d[0] = d[0] + d[1];
        d[1] = t;
        double t0 = d[n2];
        t = d[n - 1];
        d[n - 1] = d[1];
        const Cx *wave = p.wave.data();
        const double scale2 = 0.5;
        int j;
        for (j = 2, wave++; j < n2; j += 2, wave++) {
            double h2_re = scale2 * (d[j + 1] + t);
            double h2_im = scale2 * (d[n - j] - d[j]);
            double h1_re = scale2 * (d[j] + d[n - j]);
            double h1_im = scale2 * (d[j + 1] - t);
            t = h2_re * wave->re - h2_im * wave->im;
            h2_im = h2_re * wave->im + h2_im * wave->re;
            h2_re = t;
            t = d[n - j - 1];
            d[j - 1] = h1_re + h2_re;
            d[n - j - 1] = h1_re - h2_re;
            d[j] = h1_im + h2_im;
            d[n - j] = h2_im - h1_im;
        }
        if (j <= n2) {
            d[n2 - 1] = t0;
            d[n2] = -t;
        }
        std::memcpy(dst, d, sizeof(double) * n);
    }
}

// CCSIDFT (CCS input, real output): src of n reals -> dst of n reals, each
// times scale. tmp holds 2n doubles.
void ccs_idft(const Plan &p, const double *src, double *dst, double scale, Cx *tmp) {
    int n = p.n;
    if (n == 1) {
        dst[0] = src[0] * scale;
    } else if (n == 2) {
        double t = (src[0] + src[1]) * scale;
        dst[1] = (src[0] - src[1]) * scale;
        dst[0] = t;
    } else if (n & 1) {
        const Cx *s = reinterpret_cast<const Cx *>(src - 1);
        tmp[0].re = src[0];
        tmp[0].im = 0;
        int n2 = (n + 1) >> 1;
        for (int j = 1; j < n2; j++) {
            int k0 = p.inv_itab[j], k1 = p.inv_itab[n - j];
            double t0 = s[j].re, t1 = s[j].im;
            tmp[k0].re = t0; tmp[k0].im = -t1;
            tmp[k1].re = t0; tmp[k1].im = t1;
        }
        Opts c = whole(p, false, 1.);
        c.no_permute = true;
        dft(c, tmp, tmp);
        const double *t = reinterpret_cast<const double *>(tmp);
        dst[0] = t[0] * scale;
        for (int j = 1; j < n; j += 2) {
            double t0 = t[j * 2] * scale;
            double t1 = t[j * 2 + 2] * scale;
            dst[j] = t0;
            dst[j + 1] = t1;
        }
    } else {
        int n2 = n >> 1;
        // the half-length complex input, in natural order
        double *z = reinterpret_cast<double *>(tmp + n);
        double t = src[1];
        z[0] = src[0] + src[n - 1];
        z[1] = src[n - 1] - src[0];
        const Cx *w = p.wave.data();
        int j;
        for (j = 2, w++; j < n2; j += 2, w++) {
            double h1_re = t + src[n - j - 1];
            double h1_im = src[j] - src[n - j];
            double h2_re = t - src[n - j - 1];
            double h2_im = src[j] + src[n - j];
            t = h2_re * w->re + h2_im * w->im;
            h2_im = h2_im * w->re - h2_re * w->im;
            h2_re = t;
            t = src[j + 1];
            z[j] = h1_re - h2_im;
            z[j + 1] = -h1_im - h2_re;
            z[n - j] = h1_re + h2_im;
            z[n - j + 1] = h1_im - h2_re;
        }
        if (j <= n2) {
            z[n2] = t * 2;
            z[n2 + 1] = src[n2] * 2;
        }
        int sub[34];
        std::memcpy(sub, p.factors, sizeof(int) * p.nf);
        sub[0] >>= 1;
        Opts c{n2, p.nf - (sub[0] == 1), sub + (sub[0] == 1), &p, false, false, 1.};
        dft(c, reinterpret_cast<const Cx *>(z), tmp);
        const double *d = reinterpret_cast<const double *>(tmp);
        for (j = 0; j < n; j += 2) {
            double t0 = d[j] * scale;
            double t1 = d[j + 1] * (-scale);
            dst[j] = t0;
            dst[j + 1] = t1;
        }
    }
}

// ExpandCCS: n CCS values at p[0..n) -> n complex values.
void expand_ccs(double *p, int n) {
    for (int i = 1; i < (n + 1) / 2; i++) {
        p[(n - i) * 2] = p[i * 2 - 1];
        p[(n - i) * 2 + 1] = -p[i * 2];
    }
    if ((n & 1) == 0) {
        p[n] = p[n - 1];
        p[n + 1] = 0.;
        n--;
    }
    for (int i = n - 1; i > 0; i--) p[i + 1] = p[i];
    p[1] = 0.;
}

// The real 2-D DFT of OcvDftImpl (h >= 2), in place on an h x w array of
// doubles (row stride w). Forward: rows (the first nonzero_rows; the rest are
// zero) then columns. Inverse with scale: columns, then the first
// nonzero_rows rows (the rest set to zero), times scale.
struct Dft2 {
    int h, w;
    Plan rows, cols;
    std::vector<Cx> tmp, buf0, buf1;
    std::vector<double> line;

    Dft2(int h_, int w_)
        : h(h_), w(w_), rows(w_), cols(h_), tmp(2 * (w_ > h_ ? w_ : h_) + 2),
          buf0(h_ + 1), buf1(h_ + 1), line(w_) {}

    void row_pass(double *a, int nonzero, bool inv, double scale) {
        for (int i = 0; i < nonzero; i++) {
            double *r = a + (long)i * w;
            if (inv)
                ccs_idft(rows, r, line.data(), scale, tmp.data());
            else
                real_dft(rows, r, line.data(), tmp.data());
            std::memcpy(r, line.data(), sizeof(double) * w);
        }
        for (int i = nonzero; i < h; i++) std::memset(a + (long)i * w, 0, sizeof(double) * w);
    }

    void column(const Cx *in, Cx *out, bool inv) {
        dft(whole(cols, inv, 1.), in, out);
    }

    void col_pass(double *a, bool inv) {
        bool even = (w & 1) == 0;
        int b = (w + 1) / 2;
        Cx *t = tmp.data();
        // the first and (even width) the last column: real
        for (int e = 0; e < 1 + even; e++) {
            int col = e ? w - 1 : 0;
            Cx *bf = buf0.data();
            if (!inv) {
                for (int i = 0; i < h; i++) bf[i] = Cx{a[(long)i * w + col], 0.};
                column(bf, t, false);
                const double *d = reinterpret_cast<const double *>(t);
                a[col] = d[0];
                for (int i = 1; i < h; i++) a[(long)i * w + col] = d[i + 1];
            } else {
                double *d = reinterpret_cast<double *>(bf);
                for (int i = 0; i < h; i++) d[i] = a[(long)i * w + col];
                expand_ccs(d, h);
                column(bf, t, true);
                for (int i = 0; i < h; i++) a[(long)i * w + col] = t[i].re;
            }
        }
        // the complex columns (2k-1, 2k)
        for (int k = 1; k < b; k++) {
            Cx *bf = buf0.data();
            for (int i = 0; i < h; i++)
                bf[i] = Cx{a[(long)i * w + 2 * k - 1], a[(long)i * w + 2 * k]};
            column(bf, t, inv);
            for (int i = 0; i < h; i++) {
                a[(long)i * w + 2 * k - 1] = t[i].re;
                a[(long)i * w + 2 * k] = t[i].im;
            }
        }
    }

    void forward(double *a, int nonzero) {
        row_pass(a, nonzero, false, 1.);
        col_pass(a, false);
    }

    void inverse(double *a, int nonzero, double scale) {
        col_pass(a, true);
        row_pass(a, nonzero, true, scale);
    }
};

// getOptimalDFTSize: the least 2^a·3^b·5^c >= n.
int optimal_dft_size(int n) {
    if (n <= 1) return 1;
    long best = -1;
    for (long p5 = 1; p5 < 2L * n; p5 *= 5)
        for (long p3 = p5; p3 < 2L * n; p3 *= 3) {
            long v = p3;
            while (v < n) v *= 2;
            if (best < 0 || v < best) best = v;
        }
    return (int)best;
}

int reflect101(int p, int len) {
    if (len == 1) return 0;
    while ((unsigned)p >= (unsigned)len) {
        if (p < 0)
            p = -p;
        else
            p = 2 * len - 2 - p;
    }
    return p;
}

// A length the tables cover: any, but powers of two only to kMaxPow2.
bool supported(int n) { return n >= 1 && ((n & (n - 1)) != 0 || n <= kMaxPow2); }

}  // namespace

extern "C" {

// Complex 1-D DFT of n values (interleaved re, im): inv, scale as cv::dft's
// DFT_INVERSE and DFT_SCALE. For the tests.
int host_dft_complex(int n, int inv, double scale, const double *src, double *dst) {
    if (!supported(n)) return -1;
    Plan p(n);
    dft(whole(p, inv != 0, scale), reinterpret_cast<const Cx *>(src), reinterpret_cast<Cx *>(dst));
    return 0;
}

// The real 2-D DFT of an h x w array in place (CCS), or its inverse with
// DFT_SCALE (inv != 0): cv::dft's result on one channel of doubles.
int host_dft_real2d(int h, int w, int inv, int nonzero_rows, double *a) {
    if (h < 2 || !supported(h) || !supported(w)) return -1;
    if (nonzero_rows <= 0 || nonzero_rows > h) nonzero_rows = h;
    Dft2 d(h, w);
    if (inv)
        d.inverse(a, nonzero_rows, 1. / ((double)w * h));
    else
        d.forward(a, nonzero_rows);
    return 0;
}

// cv::filter2D's DFT path (crossCorr, anchor at the kernel's centre,
// BORDER_REFLECT_101) on an h x w x cn image of doubles (channels
// interleaved) with a kh x kw kernel of doubles: dst (h x w x cn doubles)
// is the correlation in double, which the caller rounds to the image's
// depth. → 0, or -1 on bad arguments.
int host_dft_filter2d(const double *src, int h, int w, int cn, const double *kernel, int kh,
                      int kw, double *dst) {
    if (h < 1 || w < 1 || cn < 1 || kh < 1 || kw < 1) return -1;
    const int ax = kw / 2, ay = kh / 2;
    const double block_scale = 4.5;
    const int min_block = 256;
    int bw = (int)std::lrint(kw * block_scale);
    if (bw < min_block - kw + 1) bw = min_block - kw + 1;
    if (bw > w) bw = w;
    int bh = (int)std::lrint(kh * block_scale);
    if (bh < min_block - kh + 1) bh = min_block - kh + 1;
    if (bh > h) bh = h;
    int dw = optimal_dft_size(bw + kw - 1);
    if (dw < 2) dw = 2;
    int dh = optimal_dft_size(bh + kh - 1);
    if (!supported(dw) || !supported(dh)) return -1;
    bw = dw - kw + 1;
    if (bw > w) bw = w;
    bh = dh - kh + 1;
    if (bh > h) bh = h;

    Dft2 d(dh, dw);
    std::vector<double> templ((size_t)dh * dw, 0.), img((size_t)dh * dw);
    for (int i = 0; i < kh; i++)
        for (int j = 0; j < kw; j++) templ[(size_t)i * dw + j] = kernel[(size_t)i * kw + j];
    d.forward(templ.data(), kh);

    int tiles_x = (w + bw - 1) / bw, tiles_y = (h + bh - 1) / bh;
    for (int ti = 0; ti < tiles_x * tiles_y; ti++) {
        int x = (ti % tiles_x) * bw, y = (ti / tiles_x) * bh;
        int bsw = bw < w - x ? bw : w - x, bsh = bh < h - y ? bh : h - y;
        int dsw = bsw + kw - 1, dsh = bsh + kh - 1;
        int x0 = x - ax, y0 = y - ay;
        int x1 = x0 > 0 ? x0 : 0, y1 = y0 > 0 ? y0 : 0;
        int x2 = w < x0 + dsw ? w : x0 + dsw, y2 = h < y0 + dsh ? h : y0 + dsh;
        for (int k = 0; k < cn; k++) {
            std::fill(img.begin(), img.end(), 0.);
            // the tile's part of the image, then copyMakeBorder from it
            for (int i = 0; i < dsh; i++) {
                int sy = y1 + reflect101(y0 + i - y1, y2 - y1);
                for (int j = 0; j < dsw; j++) {
                    int sx = x1 + reflect101(x0 + j - x1, x2 - x1);
                    img[(size_t)i * dw + j] = src[((size_t)sy * w + sx) * cn + k];
                }
            }
            d.forward(img.data(), dsh);
            // mulSpectrums(img, templ, img, 0, conjB = true) on CCS spectra
            double *A = img.data();
            const double *B = templ.data();
            int rows = dh, cols = dw;
            for (int e = 0; e < (cols % 2 ? 1 : 2); e++) {
                int c0 = e ? cols - 1 : 0;
                A[c0] = A[c0] * B[c0];
                if (rows % 2 == 0) {
                    size_t l = (size_t)(rows - 1) * dw + c0;
                    A[l] = A[l] * B[l];
                }
                for (int j = 1; j <= rows - 2; j += 2) {
                    size_t p0 = (size_t)j * dw + c0, p1 = p0 + dw;
                    double re = A[p0] * B[p0] + A[p1] * B[p1];
                    double im = A[p1] * B[p0] - A[p0] * B[p1];
                    A[p0] = re;
                    A[p1] = im;
                }
            }
            int j1 = cols - (cols % 2 == 0);
            for (int i = 0; i < rows; i++) {
                double *a = A + (size_t)i * dw;
                const double *b = B + (size_t)i * dw;
                for (int j = 1; j < j1; j += 2) {
                    double re = a[j] * b[j] + a[j + 1] * b[j + 1];
                    double im = a[j + 1] * b[j] - a[j] * b[j + 1];
                    a[j] = re;
                    a[j + 1] = im;
                }
            }
            d.inverse(img.data(), bsh, 1. / ((double)dw * dh));
            for (int i = 0; i < bsh; i++)
                for (int j = 0; j < bsw; j++)
                    dst[((size_t)(y + i) * w + x + j) * cn + k] = img[(size_t)i * dw + j];
        }
    }
    return 0;
}

}  // extern "C"
