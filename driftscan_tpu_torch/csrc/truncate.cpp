// Precision truncation of complex transfer matrices for compressibility.
//
// Host codec (not a device kernel): the equivalent of caput's
// bit_truncate, applied to BTMs before they are written as compressed HDF5.
// Rounds each real/imag component onto the power-of-two grid just below a
// per-element tolerance: max(rel * |x|, maxl * max_row |x|).
//
// Built at first use by driftscan_tpu_torch/ops/truncate.py with the host
// C++ compiler (backend.build_host).

#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

inline double round_to_grid(double x, double tol) {
    if (tol < 1e-300) tol = 1e-300;
    // Power-of-two granularity just below tol
    int e;
    std::frexp(tol, &e);              // tol = m * 2^e, m in [0.5, 1)
    const double g = std::ldexp(1.0, e - 1);  // 2^(e-1) <= tol < 2^e
    return std::nearbyint(x / g) * g;
}

}  // namespace

extern "C" {

// arr: interleaved complex128 (n rows, k columns), modified in place.
void bit_truncate_max_complex(void* data, long n, long k, double rel,
                              double maxl) {
    double* arr = reinterpret_cast<double*>(data);

#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (long i = 0; i < n; ++i) {
        double* row = arr + 2 * i * k;

        // Row maximum magnitude
        double rowmax = 0.0;
        for (long j = 0; j < k; ++j) {
            const double re = row[2 * j];
            const double im = row[2 * j + 1];
            const double mag = std::hypot(re, im);
            if (mag > rowmax) rowmax = mag;
        }

        for (long j = 0; j < k; ++j) {
            const double re = row[2 * j];
            const double im = row[2 * j + 1];
            const double mag = std::hypot(re, im);
            double tol = rel * mag;
            const double tol2 = maxl * rowmax;
            if (tol2 > tol) tol = tol2;
            if (tol <= 0.0) continue;
            row[2 * j] = round_to_grid(re, tol);
            row[2 * j + 1] = round_to_grid(im, tol);
        }
    }
}

}  // extern "C"
