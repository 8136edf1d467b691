// One step of the normalised associated Legendre recurrence in l, shared by
// the analysis (K3+K5, legendre_sht.cu) and synthesis (K14,
// legendre_synth.cu) kernels.
//
// The recurrence of driftscan_tpu/ops/sht.py:_legendre_chunk in float64 with
// the JAX package's constants: mantissas (u0, u1) and a log scale s per
// (m, ring), rescaled by 1e+-30 whenever a mantissa leaves [1e-30, 1e30].
// The JAX form sign(u) exp(s + log|u|) per lambda is replaced by u * exp(s)
// with exp(s) refreshed only when s changes (the seed and rescale events),
// which removes two float64 transcendentals from every step.  Values below
// exp(-87) are emitted as exact zeros, as there.

#pragma once

#include <math.h>

namespace legendre {

constexpr double kBig = 1e30;
constexpr double kSmall = 1e-30;
constexpr double kLogBig = 69.07755278982137;     // log(1e30)
constexpr double kTiny = 1.6458114310822737e-38;  // exp(-87)
constexpr double kExpFloor = -745.0;              // exp() underflows below

// Recurrence coefficients of step l at order m (the l <= m guards of the
// JAX code keep every denominator positive).
__device__ __forceinline__ double coef_a(double l, double mf) {
  return sqrt(fmax(4.0 * l * l - 1.0, 0.0) / fmax(l * l - mf * mf, 1.0));
}

__device__ __forceinline__ double coef_b(double l, double mf) {
  return sqrt(fmax((l - 1.0) * (l - 1.0) - mf * mf, 0.0) /
              fmax(4.0 * (l - 1.0) * (l - 1.0) - 1.0, 1.0));
}

// The recurrence state of one (m, ring): two mantissas, the log scale and
// its exponential.
struct State {
  double u0 = 0.0, u1 = 0.0, s = -1e6, sc = 0.0;
};

// exp(s), or 0 where it underflows: the factor a state's mantissa carries.
__device__ __forceinline__ double scale(double s) { return (s > kExpFloor) ? exp(s) : 0.0; }

// lambda_lm(theta) for l >= m, advancing `st` from l - 1 to l.  x = cos
// theta, sin_r = sin theta; sgn = (-1)^m and sq = sqrt(2m + 3); a, b the
// coefficients of step l (used for l >= m + 2); logpref[m] the log of
// lambda_mm's prefactor.
__device__ __forceinline__ double step(State& st, int l, int m, double mf,
                                       double x, double sin_r, double a,
                                       double b, double sgn, double sq,
                                       const double* __restrict__ logpref) {
  double u_new;
  bool refresh = false;
  if (l == m) {
    u_new = sgn;
    st.s = logpref[m] + mf * log(fmax(sin_r, 1e-30));
    refresh = true;
  } else if (l == m + 1) {
    u_new = x * sq * st.u1;
  } else {
    u_new = a * (x * st.u1 - b * st.u0);
  }
  const double mx = fmax(fabs(u_new), fabs(st.u1));
  double factor = 1.0;
  if (mx > kBig) {
    factor = kSmall;
    st.s += kLogBig;
    refresh = true;
  } else if (mx > 0.0 && mx < kSmall) {
    factor = kBig;
    st.s -= kLogBig;
    refresh = true;
  }
  st.u0 = st.u1 * factor;
  st.u1 = u_new * factor;
  if (refresh) st.sc = scale(st.s);
  const double lam = st.u1 * st.sc;
  return fabs(lam) <= kTiny ? 0.0 : lam;
}

}  // namespace legendre
