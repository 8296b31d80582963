/* Monotonic DTW for cross-attention word-timestamp alignment.
 *
 * Hot host-side kernel of the streaming loop: every transcription window runs
 * DTW over (n_tokens × n_frames) ≈ 100 × 1500 — a pure-Python DP costs
 * 50–100 ms per window, this C version ~0.1 ms. Built by native/build.py into
 * librtwa_native.so and loaded via ctypes (timestamps.py); the Python DP
 * remains as a fallback and as the parity oracle in tests.
 *
 * Contract (matches timestamps.dtw_path): cost is row-major (n × m) float64;
 * outputs are the backtraced path (token_idx, frame_idx), length ≤ n + m,
 * written front-to-back; returns the path length.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

int64_t rtwa_dtw(const double *cost, int64_t n, int64_t m,
                 int32_t *out_ti, int32_t *out_fj) {
    if (n <= 0 || m <= 0) return 0;
    const double INF = 1e300;
    /* acc has (n+1) x (m+1), trace packed 2 bits -> bytes for simplicity */
    double *prev = (double *)malloc((size_t)(m + 1) * sizeof(double));
    double *cur = (double *)malloc((size_t)(m + 1) * sizeof(double));
    unsigned char *trace = (unsigned char *)malloc((size_t)n * (size_t)m);
    if (!prev || !cur || !trace) { free(prev); free(cur); free(trace); return -1; }

    prev[0] = 0.0;
    for (int64_t j = 1; j <= m; j++) prev[j] = INF;

    for (int64_t i = 1; i <= n; i++) {
        const double *row = cost + (i - 1) * m;
        unsigned char *trow = trace + (i - 1) * m;
        cur[0] = INF;
        for (int64_t j = 1; j <= m; j++) {
            double c0 = prev[j - 1]; /* diagonal */
            double c1 = prev[j];     /* token advance */
            double c2 = cur[j - 1];  /* frame advance */
            double best;
            unsigned char t;
            if (c0 <= c1 && c0 <= c2) { best = c0; t = 0; }
            else if (c1 <= c2)        { best = c1; t = 1; }
            else                      { best = c2; t = 2; }
            cur[j] = best + row[j - 1];
            trow[j - 1] = t;
        }
        double *tmp = prev; prev = cur; cur = tmp;
    }

    /* backtrace */
    int64_t i = n, j = m, k = 0;
    int64_t cap = n + m;
    while (i > 0 && j > 0 && k < cap) {
        out_ti[k] = (int32_t)(i - 1);
        out_fj[k] = (int32_t)(j - 1);
        unsigned char t = trace[(i - 1) * m + (j - 1)];
        k++;
        if (t == 0) { i--; j--; }
        else if (t == 1) { i--; }
        else { j--; }
    }
    /* reverse in place */
    for (int64_t a = 0, b = k - 1; a < b; a++, b--) {
        int32_t tt = out_ti[a]; out_ti[a] = out_ti[b]; out_ti[b] = tt;
        int32_t tf = out_fj[a]; out_fj[a] = out_fj[b]; out_fj[b] = tf;
    }
    free(prev); free(cur); free(trace);
    return k;
}

/* Median filter (odd width, edge-padded) over rows of an (n × m) matrix —
 * the other per-window host DSP in the timestamp path. */
static int cmp_double(const void *a, const void *b) {
    double x = *(const double *)a, y = *(const double *)b;
    return (x > y) - (x < y);
}

void rtwa_median_filter(const double *x, int64_t n, int64_t m, int64_t width,
                        double *out) {
    int64_t half = width / 2;
    /* small widths (the product uses 7): stack window + insertion sort —
       a qsort(3) call per window costs ~100x the comparisons themselves and
       made this the hot-parse hog at ~6 ms per 40x800 tick */
    if (width == 7) {
        /* the product width: branchless median-of-7 selection network
           (insertion sort's data-dependent branches mispredict ~50% on
           attention data and dominated at ~60 ns/window) */
        for (int64_t i = 0; i < n; i++) {
            const double *row = x + i * m;
            double *orow = out + i * m;
            for (int64_t j = 0; j < m; j++) {
                int64_t lo = j - 3;
                double a0, a1, a2, a3, a4, a5, a6;
                if (lo >= 0 && lo + 7 <= m) {
                    const double *w0 = row + lo;
                    a0 = w0[0]; a1 = w0[1]; a2 = w0[2]; a3 = w0[3];
                    a4 = w0[4]; a5 = w0[5]; a6 = w0[6];
                } else {
                    int64_t i0 = lo < 0 ? 0 : lo;
                    int64_t i6 = lo + 6 >= m ? m - 1 : lo + 6;
                    a0 = row[i0];
                    a1 = row[lo + 1 < 0 ? 0 : (lo + 1 >= m ? m - 1 : lo + 1)];
                    a2 = row[lo + 2 < 0 ? 0 : (lo + 2 >= m ? m - 1 : lo + 2)];
                    a3 = row[lo + 3 < 0 ? 0 : (lo + 3 >= m ? m - 1 : lo + 3)];
                    a4 = row[lo + 4 < 0 ? 0 : (lo + 4 >= m ? m - 1 : lo + 4)];
                    a5 = row[lo + 5 < 0 ? 0 : (lo + 5 >= m ? m - 1 : lo + 5)];
                    a6 = row[i6];
                }
#define CE(p, q) { double lo_ = p < q ? p : q, hi_ = p < q ? q : p; p = lo_; q = hi_; }
                /* median-of-7 network (13 compare-exchanges) */
                CE(a0, a5) CE(a0, a3) CE(a1, a6) CE(a2, a4) CE(a0, a1)
                CE(a3, a5) CE(a2, a6) CE(a2, a3) CE(a3, a6) CE(a4, a5)
                CE(a1, a4) CE(a1, a3) CE(a3, a4)
#undef CE
                orow[j] = a3;
            }
        }
        return;
    }
    if (width <= 32) {
        double win[32];
        for (int64_t i = 0; i < n; i++) {
            const double *row = x + i * m;
            double *orow = out + i * m;
            for (int64_t j = 0; j < m; j++) {
                int64_t lo = j - half;
                if (lo >= 0 && lo + width <= m) {
                    /* bulk: contiguous window, no clamping */
                    const double *w0 = row + lo;
                    for (int64_t k = 0; k < width; k++) {
                        double v = w0[k];
                        int64_t q = k;
                        while (q > 0 && win[q - 1] > v) {
                            win[q] = win[q - 1];
                            q--;
                        }
                        win[q] = v;
                    }
                } else {
                    for (int64_t k = 0; k < width; k++) {
                        int64_t idx = lo + k;
                        if (idx < 0) idx = 0;
                        if (idx >= m) idx = m - 1;
                        double v = row[idx];
                        int64_t q = k;
                        while (q > 0 && win[q - 1] > v) {
                            win[q] = win[q - 1];
                            q--;
                        }
                        win[q] = v;
                    }
                }
                orow[j] = win[width / 2];
            }
        }
        return;
    }
    double *win = (double *)malloc((size_t)width * sizeof(double));
    if (!win) return;
    for (int64_t i = 0; i < n; i++) {
        const double *row = x + i * m;
        double *orow = out + i * m;
        for (int64_t j = 0; j < m; j++) {
            for (int64_t k = 0; k < width; k++) {
                int64_t idx = j - half + k;
                if (idx < 0) idx = 0;
                if (idx >= m) idx = m - 1;
                win[k] = row[idx];
            }
            qsort(win, (size_t)width, sizeof(double), cmp_double);
            orow[j] = win[width / 2];
        }
    }
    free(win);
}
