// K3+K5: the Legendre stage of the forward SHT, lambda generated on the fly.
//
// Replaces the JAX programs driftscan_tpu/ops/sht.py:_legendre_chunk (the
// normalised associated Legendre recurrence, K3) and the Legendre stage of
// _analysis_split (sht.py:729-748, K5):
//
//   pos[b, l, m] = Omega * sum_r lambda_lm(theta_r) F[b, m, r]
//   neg[b, l, m] = Omega * (-1)^m * sum_r lambda_lm(theta_r) G[b, m, r]
//
// The JAX package tabulates lambda (up to a GB per nside/lmax) and runs a
// batched matmul.  Here no table exists: a block owns one m and a tile of
// BT units; for each tile of TL multipoles it sweeps the rings in tiles of
// RT, each thread advancing one ring's recurrence TL steps (float64, the
// JAX constants and rescaling) into shared memory, then every thread
// accumulates one (l, unit) output pair (pos and neg) over the ring tile.
// The per-ring recurrence state (two mantissas, the log scale and its
// exponential) lives in a global scratch slab between multipole tiles.
//
// What bounds it on an H100: float64 issue in the recurrence (~15 flops a
// lambda, recomputed once per unit tile), not memory: the phase-stage
// inputs (B, nm, nring) are streamed from L2 once per multipole tile.  The
// recurrence step (legendre_rec.cuh) is shared with the synthesis kernel
// K14 (legendre_synth.cu).
//
// Plain version: driftscan_tpu_torch.ops.sht.legendre_contract_ref.

#include <cuda_runtime.h>
#include <math.h>

#include "legendre_rec.cuh"

namespace {

constexpr int BT = 16;    // units per block
constexpr int TL = 16;    // multipoles per tile
constexpr int RT = 256;   // rings per tile == threads per block

template <typename T>
struct cpx {
  T re, im;
};

template <typename T>
__global__ void __launch_bounds__(RT)
legendre_sht_kernel(const cpx<T>* __restrict__ F, const cpx<T>* __restrict__ G,
                    const double* __restrict__ cos_t,
                    const double* __restrict__ sin_t,
                    const double* __restrict__ logpref,
                    double* __restrict__ state, cpx<T>* __restrict__ pos,
                    cpx<T>* __restrict__ neg, int B, int nm, int nring,
                    int lmax, double pixarea) {
  const int m = blockIdx.x;
  const int b0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int nl = lmax + 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* lam_s = reinterpret_cast<T*>(smem_raw);                     // [TL][RT]
  cpx<T>* f_s = reinterpret_cast<cpx<T>*>(lam_s + TL * RT);      // [RT][BT+1]
  cpx<T>* g_s = f_s + RT * (BT + 1);                             // [RT][BT+1]
  __shared__ double a_s[TL], b_s[TL];

  // per-block recurrence state: (u0, u1, s, exp(s)) per ring
  double* st = state + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * nring * 4;
  for (int r = tid; r < nring; r += RT) {
    st[r * 4 + 0] = 0.0;
    st[r * 4 + 1] = 0.0;
    st[r * 4 + 2] = -1e6;
    st[r * 4 + 3] = 0.0;
  }

  const double mf = (double)m;
  const double sgn = (m % 2 == 0) ? 1.0 : -1.0;
  const double sq = sqrt(2.0 * mf + 3.0);
  const T outscale_neg = (T)(pixarea * sgn);
  const T outscale_pos = (T)pixarea;

  // this thread's output pair within a (TL, BT) tile
  const int oli = tid / BT;
  const int ob = tid % BT;
  const int bglob = b0 + ob;

  for (int l0 = 0; l0 < nl; l0 += TL) {
    const int lo = l0 + oli;
    if (l0 + TL <= m) {  // whole tile below the seed: exact zeros
      if (bglob < B && lo < nl) {
        size_t o = ((size_t)bglob * nl + lo) * nm + m;
        pos[o] = cpx<T>{(T)0, (T)0};
        neg[o] = cpx<T>{(T)0, (T)0};
      }
      continue;
    }
    if (tid < TL) {
      const double l = (double)(l0 + tid);
      a_s[tid] = legendre::coef_a(l, mf);
      b_s[tid] = legendre::coef_b(l, mf);
    }
    __syncthreads();

    T acc_pr = 0, acc_pi = 0, acc_nr = 0, acc_ni = 0;
    for (int r0 = 0; r0 < nring; r0 += RT) {
      const int r = r0 + tid;
      // ---- recurrence: TL steps of this thread's ring ----
      if (r < nring) {
        legendre::State rs;
        rs.u0 = st[r * 4 + 0];
        rs.u1 = st[r * 4 + 1];
        rs.s = st[r * 4 + 2];
        rs.sc = st[r * 4 + 3];
        const double x = cos_t[r];
        const double sin_r = sin_t[r];
        for (int li = 0; li < TL; ++li) {
          const int l = l0 + li;
          double lam = 0.0;
          if (l >= m && l <= lmax) {
            lam = legendre::step(rs, l, m, mf, x, sin_r, a_s[li], b_s[li], sgn,
                                 sq, logpref);
          }
          lam_s[li * RT + tid] = (T)lam;
        }
        st[r * 4 + 0] = rs.u0;
        st[r * 4 + 1] = rs.u1;
        st[r * 4 + 2] = rs.s;
        st[r * 4 + 3] = rs.sc;
      } else {
        for (int li = 0; li < TL; ++li) lam_s[li * RT + tid] = (T)0;
      }
      // ---- stage this ring tile of F and G for the block's units ----
      for (int bb = 0; bb < BT; ++bb) {
        const int b = b0 + bb;
        cpx<T> fv{(T)0, (T)0}, gv{(T)0, (T)0};
        if (r < nring && b < B) {
          const size_t i = ((size_t)b * nm + m) * nring + r;
          fv = F[i];
          gv = G[i];
        }
        f_s[tid * (BT + 1) + bb] = fv;
        g_s[tid * (BT + 1) + bb] = gv;
      }
      __syncthreads();
      // ---- contraction over the ring tile ----
      const T* lrow = lam_s + oli * RT;
#pragma unroll 4
      for (int rr = 0; rr < RT; ++rr) {
        const T lv = lrow[rr];
        const cpx<T> fv = f_s[rr * (BT + 1) + ob];
        const cpx<T> gv = g_s[rr * (BT + 1) + ob];
        acc_pr += lv * fv.re;
        acc_pi += lv * fv.im;
        acc_nr += lv * gv.re;
        acc_ni += lv * gv.im;
      }
      __syncthreads();
    }
    if (bglob < B && lo < nl) {
      size_t o = ((size_t)bglob * nl + lo) * nm + m;
      pos[o] = cpx<T>{outscale_pos * acc_pr, outscale_pos * acc_pi};
      neg[o] = cpx<T>{outscale_neg * acc_nr, outscale_neg * acc_ni};
    }
  }
}

template <typename T>
int launch(const void* F, const void* G, const double* cos_t,
           const double* sin_t, const double* logpref, double* state,
           void* pos, void* neg, int B, int nm, int nring, int lmax,
           double pixarea, cudaStream_t stream) {
  const size_t smem = sizeof(T) * TL * RT + sizeof(cpx<T>) * RT * (BT + 1) * 2;
  cudaError_t e = cudaFuncSetAttribute(
      legendre_sht_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(nm, (B + BT - 1) / BT);
  legendre_sht_kernel<T><<<grid, RT, smem, stream>>>(
      static_cast<const cpx<T>*>(F), static_cast<const cpx<T>*>(G), cos_t,
      sin_t, logpref, state, static_cast<cpx<T>*>(pos),
      static_cast<cpx<T>*>(neg), B, nm, nring, lmax, pixarea);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of (m, unit tile) blocks: the state slab holds nring*4 doubles each.
int legendre_sht_state_blocks(int B, int nm) { return nm * ((B + BT - 1) / BT); }

int legendre_sht_c64(const void* F, const void* G, const double* cos_t,
                     const double* sin_t, const double* logpref, double* state,
                     void* pos, void* neg, int B, int nm, int nring, int lmax,
                     double pixarea, void* stream) {
  return launch<float>(F, G, cos_t, sin_t, logpref, state, pos, neg, B, nm,
                       nring, lmax, pixarea, (cudaStream_t)stream);
}

int legendre_sht_c128(const void* F, const void* G, const double* cos_t,
                      const double* sin_t, const double* logpref,
                      double* state, void* pos, void* neg, int B, int nm,
                      int nring, int lmax, double pixarea, void* stream) {
  return launch<double>(F, G, cos_t, sin_t, logpref, state, pos, neg, B, nm,
                        nring, lmax, pixarea, (cudaStream_t)stream);
}

}  // extern "C"
