// K14: the Legendre stage of the inverse SHT, lambda generated on the fly.
//
// Replaces the JAX programs driftscan_tpu/ops/sht.py:_legendre_chunk (the
// normalised associated Legendre recurrence) and the Legendre contraction of
// _synthesis_real (sht.py:513) and _synthesis_complex (sht.py:569-570):
//
//   tpos[b, m, r] = sum_{l=m}^{lmax} lambda_lm(theta_r) pos[b, l, m]
//   tneg[b, m, r] = (-1)^m sum_{l=m}^{lmax} lambda_lm(theta_r) a[b, l, -m]
//
// with a[b, l, -m] = neg[b, l, m - 1] for m >= 1 (tneg at m = 0 is zero);
// the negative block is optional (the real form has none).
//
// Design: a block owns one m, a tile of RT rings and a tile of BT units.
// Each thread owns one ring and runs the three-term recurrence in l from m
// upwards in float64 (legendre_rec.cuh, the analysis kernel's step), using
// each lambda at once for its BT (2 BT with the negative block) complex
// multiply-adds against the column a[:, l, m], which the block stages in
// shared memory LC multipoles at a time with the step coefficients.  The
// accumulators stay in registers, so no lambda table, no lambda tile and no
// recurrence state leave the thread: the contraction runs along the
// recurrence's own axis.  The grid runs the heaviest m (small m: lmax + 1 -
// m steps) first.
//
// What bounds it on an H100: float64 issue, ~12 flops of recurrence and 4 BT
// (8 BT) flops of contraction per lambda on the CUDA cores; memory traffic
// is the alm columns (from L2, once per ring tile) and the (B, nm, nring)
// outputs, written once and coalesced along the rings.
//
// Plain version: driftscan_tpu_torch.ops.sht.legendre_synth_ref.

#include <cuda_runtime.h>
#include <math.h>

#include "legendre_rec.cuh"

namespace {

constexpr int BT = 8;     // units per block
constexpr int LC = 32;    // multipoles staged per chunk
constexpr int RT = 128;   // rings per tile == threads per block

template <typename T>
struct cpx {
  T re, im;
};

template <typename T, bool NEG>
__global__ void __launch_bounds__(RT)
legendre_synth_kernel(const cpx<T>* __restrict__ pos,
                      const cpx<T>* __restrict__ neg,
                      const double* __restrict__ cos_t,
                      const double* __restrict__ sin_t,
                      const double* __restrict__ logpref,
                      cpx<T>* __restrict__ tpos, cpx<T>* __restrict__ tneg,
                      int B, int nm, int nring, int lmax) {
  const int r = blockIdx.x * RT + threadIdx.x;
  const int m = blockIdx.y;
  const int b0 = blockIdx.z * BT;
  const int tid = threadIdx.x;
  const int nl = lmax + 1;

  __shared__ double a_s[LC], b_s[LC];
  __shared__ cpx<T> pos_s[LC][BT];
  __shared__ cpx<T> neg_s[NEG ? LC : 1][BT];

  const double mf = (double)m;
  const double sgn = (m % 2 == 0) ? 1.0 : -1.0;
  const double sq = sqrt(2.0 * mf + 3.0);
  const bool ring = r < nring;
  const double x = ring ? cos_t[r] : 0.0;
  const double sin_r = ring ? sin_t[r] : 1.0;

  T acc_pr[BT], acc_pi[BT], acc_nr[BT], acc_ni[BT];
#pragma unroll
  for (int bb = 0; bb < BT; ++bb) {
    acc_pr[bb] = acc_pi[bb] = acc_nr[bb] = acc_ni[bb] = (T)0;
  }

  legendre::State st;
  for (int l0 = m; l0 < nl; l0 += LC) {
    const int nlc = min(LC, nl - l0);
    // ---- stage this chunk's coefficients and alm columns ----
    if (tid < nlc) {
      const double l = (double)(l0 + tid);
      a_s[tid] = legendre::coef_a(l, mf);
      b_s[tid] = legendre::coef_b(l, mf);
    }
    for (int i = tid; i < LC * BT; i += RT) {
      const int li = i / BT, bb = i % BT;
      const int b = b0 + bb;
      cpx<T> pv{(T)0, (T)0}, nv{(T)0, (T)0};
      if (li < nlc && b < B) {
        const size_t row = (size_t)b * nl + (l0 + li);
        pv = pos[row * nm + m];
        if constexpr (NEG) if (m > 0) nv = neg[row * (nm - 1) + (m - 1)];
      }
      pos_s[li][bb] = pv;
      if constexpr (NEG) neg_s[li][bb] = nv;
    }
    __syncthreads();
    // ---- recurrence and contraction over the chunk ----
    if (ring) {
      for (int li = 0; li < nlc; ++li) {
        const T lam = (T)legendre::step(st, l0 + li, m, mf, x, sin_r, a_s[li],
                                        b_s[li], sgn, sq, logpref);
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) {
          const cpx<T> pv = pos_s[li][bb];
          acc_pr[bb] += lam * pv.re;
          acc_pi[bb] += lam * pv.im;
          if constexpr (NEG) {
            const cpx<T> nv = neg_s[li][bb];
            acc_nr[bb] += lam * nv.re;
            acc_ni[bb] += lam * nv.im;
          }
        }
      }
    }
    __syncthreads();
  }

  if (!ring) return;
  const T nsgn = (T)sgn;
#pragma unroll
  for (int bb = 0; bb < BT; ++bb) {
    const int b = b0 + bb;
    if (b < B) {
      const size_t o = ((size_t)b * nm + m) * nring + r;
      tpos[o] = cpx<T>{acc_pr[bb], acc_pi[bb]};
      if constexpr (NEG) tneg[o] = cpx<T>{nsgn * acc_nr[bb], nsgn * acc_ni[bb]};
    }
  }
}

template <typename T>
int launch(const void* pos, const void* neg, const double* cos_t,
           const double* sin_t, const double* logpref, void* tpos, void* tneg,
           int B, int nm, int nring, int lmax, cudaStream_t stream) {
  dim3 grid((nring + RT - 1) / RT, nm, (B + BT - 1) / BT);
  if (neg != nullptr) {
    legendre_synth_kernel<T, true><<<grid, RT, 0, stream>>>(
        static_cast<const cpx<T>*>(pos), static_cast<const cpx<T>*>(neg),
        cos_t, sin_t, logpref, static_cast<cpx<T>*>(tpos),
        static_cast<cpx<T>*>(tneg), B, nm, nring, lmax);
  } else {
    legendre_synth_kernel<T, false><<<grid, RT, 0, stream>>>(
        static_cast<const cpx<T>*>(pos), nullptr, cos_t, sin_t, logpref,
        static_cast<cpx<T>*>(tpos), nullptr, B, nm, nring, lmax);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// neg and tneg null: the real form (no negative-m block).
int legendre_synth_c64(const void* pos, const void* neg, const double* cos_t,
                       const double* sin_t, const double* logpref, void* tpos,
                       void* tneg, int B, int nm, int nring, int lmax,
                       void* stream) {
  return launch<float>(pos, neg, cos_t, sin_t, logpref, tpos, tneg, B, nm,
                       nring, lmax, (cudaStream_t)stream);
}

int legendre_synth_c128(const void* pos, const void* neg, const double* cos_t,
                        const double* sin_t, const double* logpref, void* tpos,
                        void* tneg, int B, int nm, int nring, int lmax,
                        void* stream) {
  return launch<double>(pos, neg, cos_t, sin_t, logpref, tpos, tneg, B, nm,
                        nring, lmax, (cudaStream_t)stream);
}

}  // extern "C"
