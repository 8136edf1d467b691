// One step of the normalised associated Legendre recurrence in l, shared by
// the analysis (K3+K5, legendre_sht.cu) and synthesis (K14,
// legendre_synth.cu) kernels.
//
// The recurrence of driftscan_tpu/ops/sht.py:_legendre_chunk in float64 with
// the JAX package's constants: mantissas (u0, u1) and a log scale s per
// (m, ring), rescaled by 1e+-30 whenever a mantissa leaves [1e-30, 1e30].
// The JAX form sign(u) exp(s + log|u|) per lambda is replaced by u * exp(s)
// with exp(s) refreshed only when s changes (the seed and rescale events),
// which removes two float64 transcendentals from every step; those events
// run out of line (seeded, rescaled).  Values below exp(-87) are emitted as
// exact zeros, as there.  step() takes any step; exact() a step l >= m + 2
// with the rescale as selects; advance() a step l >= m + 2 with no rescale,
// which flags where one might have fallen (K14 runs groups of advance() and
// takes a flagged group again by exact()).  All three give the same bits.

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

// The state after the seed step l = m (from a fresh state: u0 = 0, u1 =
// (-1)^m, s = log of lambda_mm's prefactor + m log sin theta).  Out of line,
// as is rescaled(): a branch of step() that calls log or exp may be
// evaluated on every step and its result discarded, which costs the
// recurrence several times its own arithmetic.
static __device__ __noinline__ State seeded(int m, double mf, double sin_r, double sgn,
                                     const double* __restrict__ logpref) {
  State st;
  st.u0 = 0.0;
  st.u1 = sgn;
  st.s = logpref[m] + mf * log(fmax(sin_r, 1e-30));
  st.sc = scale(st.s);
  return st;
}

// The state after a step whose mantissas left [1e-30, 1e30]: both scaled
// by 1e-30 (up) or 1e30, the log scale moved by log(1e30), its exponential
// refreshed.
static __device__ __noinline__ State rescaled(double u1, double u_new, double s, bool up) {
  const double factor = up ? kSmall : kBig;
  State st;
  st.u0 = u1 * factor;
  st.u1 = u_new * factor;
  st.s = up ? s + kLogBig : s - kLogBig;
  st.sc = scale(st.s);
  return st;
}

// The three-term step's new mantissa, with its one rounding pinned (an
// explicit fma), so that step(), exact() and advance() agree bit for bit.
__device__ __forceinline__ double recur(double a, double b, double x, double u0, double u1) {
  return a * fma(x, u1, -(b * u0));
}

// lambda from a state whose sc is current, as step() returns it.
__device__ __forceinline__ double lambda(const State& st) {
  const double lam = st.u1 * st.sc;
  return fabs(lam) <= kTiny ? 0.0 : lam;
}

// lambda_lm(theta) for l >= m, advancing `st` from l - 1 to l.  x = cos
// theta, sin_r = sin theta; sgn = (-1)^m and sq = sqrt(2m + 3); a, b the
// coefficients of step l (used for l >= m + 2); logpref[m] the log of
// lambda_mm's prefactor.  At l = m the state is a fresh one.
__device__ __forceinline__ double step(State& st, int l, int m, double mf,
                                       double x, double sin_r, double a,
                                       double b, double sgn, double sq,
                                       const double* __restrict__ logpref) {
  if (l == m) {
    st = seeded(m, mf, sin_r, sgn, logpref);
  } else {
    const double u_new = (l == m + 1) ? x * sq * st.u1 : recur(a, b, x, st.u0, st.u1);
    const double mx = fmax(fabs(u_new), fabs(st.u1));
    if (mx > kBig || (mx > 0.0 && mx < kSmall)) {
      st = rescaled(st.u1, u_new, st.s, mx > kBig);
    } else {
      st.u0 = st.u1;
      st.u1 = u_new;
    }
  }
  return lambda(st);
}

// The biased exponent of a double (0 for zero).
__device__ __forceinline__ unsigned expo(double u) {
  return ((unsigned)__double2hiint(u) >> 20) & 0x7ffu;
}

// One step l >= m + 2 as step() takes it where no rescale falls: the new
// mantissa and the shift, with no branch and no rescale factor on the chain
// from one step to the next, so that the recurrence runs at its arithmetic's
// latency.  `moved` is set unless max(|u_new|, |u1|) lies in [2^-99, 2^99),
// inside the rescale window [1e-30, 1e30] (read from the exponent bits): a
// step that might rescale.  The caller then takes the steps again from a
// saved state by exact().  Where it is not set, the state and lambda(st)
// are step()'s bit for bit.
__device__ __forceinline__ void advance(State& st, bool& moved, double x, double a, double b) {
  const double u_new = recur(a, b, x, st.u0, st.u1);
  const unsigned e = max(expo(u_new), expo(st.u1));
  moved = moved | (e - (1023u - 99u) >= 198u);  // no short-circuit: no branch
  st.u0 = st.u1;
  st.u1 = u_new;
}

// scale(s), out of line: called only where a step rescaled.
static __device__ __noinline__ double rescale_factor(double s) { return scale(s); }

// step() for l >= m + 2, with the rescale taken by selects rather than a
// branch; only the refresh of exp(s) after a rescale is a call.
__device__ __forceinline__ double exact(State& st, double x, double a, double b) {
  const double u_new = recur(a, b, x, st.u0, st.u1);
  const double mx = fmax(fabs(u_new), fabs(st.u1));
  const bool up = mx > kBig;
  const bool down = mx > 0.0 && mx < kSmall;
  const double factor = up ? kSmall : (down ? kBig : 1.0);
  st.u0 = st.u1 * factor;
  st.u1 = u_new * factor;
  if (up || down) {
    st.s = up ? st.s + kLogBig : st.s - kLogBig;
    st.sc = rescale_factor(st.s);
  }
  return lambda(st);
}

}  // namespace legendre
