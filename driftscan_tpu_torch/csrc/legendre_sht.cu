// K3+K5: the Legendre stage of the forward SHT, lambda generated on the fly.
//
// Replaces the JAX programs driftscan_tpu/ops/sht.py:_legendre_chunk (the
// normalised associated Legendre recurrence, K3) and the Legendre stage of
// _analysis_split (sht.py:729-748, K5):
//
//   pos[b, l, j] = Omega * sum_r lambda_lm(theta_r) F[b, j, r]
//   neg[b, l, j] = Omega * (-1)^m * sum_r lambda_lm(theta_r) G[b, j, r]
//
// for m = m_lo + j: the columns of F, G, pos and neg hold the m of a window
// [m_lo, m_lo + nm) (m_lo = 0 for the full range).  The schedule holds
// physical m; an m's recurrence (its lambda_mm prefactor and the sign) is
// that m's, and its column m - m_lo.  No block's result for an m depends
// on the other m of its row, so a window's columns repeat the full range's
// bit for bit.
//
// The JAX package tabulates lambda (up to a GB per nside/lmax) and runs a
// batched matmul.  Here no table exists.  Per m the stage is one real
// product, Lambda_m (multipoles x rings) times the (rings x 4 B) matrix of
// the units' F and G planes (re F, im F, re G, im G), and a block owns one
// m -- or a pair (m_lo + j, m_last - j) from the wrapper's schedule, so that
// every block walks the same number of multipoles -- with up to BC units (BC = 64 complex64,
// 16 complex128; more units take more blocks along y, each recomputing the
// recurrence).  For each tile of TL multipoles (64 complex64, 32 complex128)
// starting at l = m it sweeps the rings in tiles of one ring a thread (512):
//   * every thread advances its ring's recurrence TL steps (float64, the
//     JAX constants and rescaling, legendre_rec.cuh) and writes that column
//     of the lambda tile into shared memory (float32 for complex64), while
//     the first F/G sub-tiles' cp.async is in flight;
//   * the block multiplies the lambda tile (A) by the F/G ring tile (B),
//     staged by cp.async in sub-tiles of KS = 32 rings through a ring of
//     NSTAGE buffers (2 complex64, 3 complex128), so the copies of the next
//     sub-tiles run under the product of this one: complex128 on the
//     float64 tensor cores (mma.sync m16n8k4.f64), complex64 as 3xTF32
//     mma.sync m16n8k8 (lambda and F each split into tf32 big and small
//     parts, both rounded to nearest, as they are read: big.big + big.small
//     + small.big; one tf32 product alone carries ~5e-4 relative error),
//     each 8-ring step's three products summed from zero and added to the
//     running float32 total on the CUDA cores, so that no sum runs through
//     the tensor cores' truncating adds for more than one step;
//   * the warps (4 along the multipoles x 4 along the columns in complex64,
//     2 x 8 in complex128) each own every NGRP-th 8-column sub-tile; a warp
//     whose rows lie past lmax skips the product; the sums run in a fixed
//     order, so two launches give the same bits.
// The outputs are written transposed, (B, nm, lmax + 1), so that a block's
// stores for its m run along l (the wrapper returns the transposes), and
// the rows below the seed as zeros.  The recurrence state (two mantissas
// and the log scale) of the block's rings lives in shared memory.  Where
// the rings do not all fit (nside above 256 in complex64, 512 in
// complex128) they are taken in ranges: each range starts its recurrences
// at l = m and adds its sums to the output rows the block owns (the first
// range stores them), in range order.
//
// What bounds it on an H100: the product's tensor-core work, 2 * 4 B flops
// per (l >= m, m, ring) (three tf32 products each in complex64), over the
// float64 recurrence (~12 flops per lambda, once per (l, m, ring) and unit
// block); the F/G planes are read once per multipole tile (from L2 or
// device memory).  Measured, the product runs at about a third of the tensor
// cores' rate and the recurrence, the F/G copies and the block's barriers
// are not hidden behind it (PERF.md).
//
// Plain version: driftscan_tpu_torch.ops.sht.legendre_contract_ref.

#include <cuda_runtime.h>
#include <math.h>

#include "legendre_rec.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr int KS = 32;  // rings per staged F/G sub-tile

template <typename T>
struct cpx {
  T re, im;
};

// The recurrence state of one ring: two mantissas and the log scale (its
// exponential is recomputed as the state is read, once per tile).
struct RingState {
  double u0, u1, s;
};

template <typename T>
struct Cfg;

// complex64: 16 warps (4 along 64 multipoles x 4 along the columns), 3xTF32
// m16n8k8; lambda kept as float32 and split into tf32 parts as it is read;
// two F/G stages
template <>
struct Cfg<float> {
  static constexpr int THREADS = 512;
  static constexpr int TL = 64;                 // multipoles per tile
  static constexpr int NSTAGE = 2;              // F/G sub-tiles in the cp.async ring
  static constexpr int BC = 64;                 // units per block (256 columns)
  static constexpr int KSTEP = 8;               // rings per mma
  static constexpr int FS = 2 * KS + 8;         // floats per staged unit row (= 8 mod 32)
  static constexpr int G_BASE = BC * FS + 16;   // = 16 mod 32: F and G lanes on disjoint banks
  static constexpr int STAGE = G_BASE + BC * FS;  // floats of one F/G stage
  using Lam = float;
};

// complex128: 16 warps (2 along 32 multipoles x 8), float64 m16n8k4;
// lambda as float64; three F/G stages.  Its paths have few units (8 to 16),
// so the recurrence, one ring a thread, sets the pace.
template <>
struct Cfg<double> {
  static constexpr int THREADS = 512;
  static constexpr int TL = 32;
  static constexpr int NSTAGE = 3;
  static constexpr int BC = 16;                 // units per block (64 columns)
  static constexpr int KSTEP = 4;
  static constexpr int FS = 2 * KS;             // doubles per staged unit row
  static constexpr int G_BASE = BC * FS + 8;    // = 8 mod 16 doubles: disjoint banks
  static constexpr int STAGE = G_BASE + BC * FS;
  using Lam = double;
};

// the recurrence tile is one ring a thread; its lambda rows are padded by 4
// elements so that a warp's A fragments fall on distinct banks
template <typename T>
__host__ __device__ constexpr int lam_stride() {
  return Cfg<T>::THREADS + 4;
}

template <typename T>
__host__ __device__ constexpr size_t lam_bytes() {
  return (size_t)Cfg<T>::TL * lam_stride<T>() * sizeof(typename Cfg<T>::Lam);
}

template <typename T>
__host__ __device__ constexpr size_t fixed_smem() {
  return lam_bytes<T>() + (size_t)Cfg<T>::NSTAGE * Cfg<T>::STAGE * sizeof(T) +
         2ull * Cfg<T>::TL * sizeof(double);
}

template <typename T>
__global__ void __launch_bounds__(Cfg<T>::THREADS)
legendre_sht_kernel(const cpx<T>* __restrict__ F, const cpx<T>* __restrict__ G,
                    const double* __restrict__ cos_t, const double* __restrict__ sin_t,
                    const double* __restrict__ logpref, const int* __restrict__ sched,
                    cpx<T>* __restrict__ pos, cpx<T>* __restrict__ neg, int B, int nm,
                    int m_lo, int nring, int lmax, int rmax, double pixarea) {
  using C = Cfg<T>;
  using Lam = typename C::Lam;
  constexpr int THREADS = C::THREADS;
  constexpr int TL = C::TL;
  constexpr int NSTAGE = C::NSTAGE;
  constexpr int RT = THREADS;             // rings per recurrence tile
  constexpr int LS = lam_stride<T>();
  constexpr int WM = TL / 16;             // warp rows (16 multipoles each)
  constexpr int NGRP = THREADS / 32 / WM; // warp columns
  constexpr int NTW = C::BC / 2 / NGRP;   // 8-column sub-tiles a warp owns, at most
  extern __shared__ __align__(16) unsigned char smem[];
  Lam* lam_s = reinterpret_cast<Lam*>(smem);                               // [TL][LS]
  T* fg_s = reinterpret_cast<T*>(smem + lam_bytes<T>());                   // [NSTAGE][STAGE]
  double* a_s =
      reinterpret_cast<double*>(smem + lam_bytes<T>() + (size_t)NSTAGE * C::STAGE * sizeof(T));
  double* b_s = a_s + TL;
  RingState* st_s = reinterpret_cast<RingState*>(b_s + TL);               // [rmax]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp % WM) * 16;  // warp's rows in the multipole tile
  const int ngrp = warp / WM;         // its sub-tiles: ngrp, ngrp + NGRP, ...
  const int nl = lmax + 1;
  const int b0 = blockIdx.y * C::BC;
  const int nb = min(C::BC, B - b0);
  const int ntiles = (nb + 1) / 2;   // 8-column sub-tiles in use (2 units each)

  for (int which = 0; which < 2; ++which) {
    const int m = sched[2 * blockIdx.x + which];
    if (m < 0) continue;
    const int col = m - m_lo;  // this m's column of F, G, pos and neg
    const double mf = (double)m;
    const double sgn = (m % 2 == 0) ? 1.0 : -1.0;
    const double sq = sqrt(2.0 * mf + 3.0);
    const T scale_pos = (T)pixarea;
    const T scale_neg = (T)(pixarea * sgn);

    // this m's F/G sub-tile of rings [rs, rs + KS) that end before rend,
    // into stage s: unit u's F at fg[u * FS + 2k], its G at G_BASE + ...
    auto stage = [&](int rs, int rend, int s) {
      T* dst = fg_s + s * C::STAGE;
      for (int e = tid; e < 2 * C::BC * KS; e += THREADS) {
        const int arr = e / (C::BC * KS);
        const int rem = e - arr * C::BC * KS;
        const int u = rem / KS, k = rem - u * KS;
        const bool ok = u < nb && rs + k < rend;
        const cpx<T>* src = arr ? G : F;
        const cpx<T>* sp = ok ? src + ((size_t)(b0 + u) * nm + col) * nring + rs + k : src;
        mma::cp_async<sizeof(cpx<T>)>(dst + (arr ? C::G_BASE : 0) + u * C::FS + 2 * k, sp, ok);
      }
      mma::cp_async_commit();
    };

    // rows below the seed are exact zeros
    for (int e = tid; e < nb * m; e += THREADS) {
      const int u = e / m, l = e - u * m;
      const size_t o = ((size_t)(b0 + u) * nm + col) * nl + l;
      pos[o] = cpx<T>{(T)0, (T)0};
      neg[o] = cpx<T>{(T)0, (T)0};
    }

    for (int r0 = 0; r0 < nring; r0 += rmax) {
      const int rend = min(r0 + rmax, nring);
      for (int r = r0 + tid; r < rend; r += THREADS)
        st_s[r - r0] = RingState{0.0, 0.0, -1e6};

      for (int l0 = m; l0 <= lmax; l0 += TL) {
        __syncthreads();  // ring states set; the previous tile's coefficients read
        if (tid < TL) {
          const double l = (double)(l0 + tid);
          a_s[tid] = legendre::coef_a(l, mf);
          b_s[tid] = legendre::coef_b(l, mf);
        }
        __syncthreads();

        T acc[NTW][4];  // the warp's sums (16 rows x 8 columns a sub-tile)
#pragma unroll
        for (int i = 0; i < NTW; ++i)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][r] = (T)0;

        for (int rt = r0; rt < rend; rt += RT) {
          const int nr = min(RT, rend - rt);
          const int nsub = (nr + KS - 1) / KS;
          // the first NSTAGE - 1 sub-tiles go out before the recurrence
          for (int sub = 0; sub < NSTAGE - 1; ++sub) {
            if (sub < nsub) stage(rt + sub * KS, rend, sub);
            else mma::cp_async_commit();
          }
          // ---- recurrence: TL steps of this thread's ring ----
          {
            legendre::State rs;
            double x = 0.0, sin_r = 0.0;
            const bool on = tid < nr;
            if (on) {
              const RingState v = st_s[rt - r0 + tid];
              rs.u0 = v.u0;
              rs.u1 = v.u1;
              rs.s = v.s;
              rs.sc = legendre::scale(v.s);
              x = cos_t[rt + tid];
              sin_r = sin_t[rt + tid];
            }
            for (int li = 0; li < TL; ++li) {
              const int l = l0 + li;
              double lam = 0.0;
              if (on && l <= lmax)
                lam = legendre::step(rs, l, m, mf, x, sin_r, a_s[li], b_s[li], sgn, sq, logpref);
              lam_s[li * LS + tid] = (Lam)lam;
            }
            if (on) st_s[rt - r0 + tid] = RingState{rs.u0, rs.u1, rs.s};
          }
          // ---- product over the ring tile, sub-tile by sub-tile ----
          for (int sub = 0; sub < nsub; ++sub) {
            // sub-tile sub + NSTAGE - 1 into the stage that sub - 1 read
            // (an empty group past the tile keeps the count of groups)
            const int ahead = sub + NSTAGE - 1;
            if (ahead < nsub) stage(rt + ahead * KS, rend, ahead % NSTAGE);
            else mma::cp_async_commit();
            mma::cp_async_wait<NSTAGE - 1>();
            __syncthreads();  // lambda tile written, this sub-tile landed
            const T* fg = fg_s + (sub % NSTAGE) * C::STAGE;
            // a warp whose 16 rows lie past lmax has nothing to multiply
            const bool rows_on = l0 + row0 <= lmax;
#pragma unroll
            for (int k0 = 0; k0 < KS; k0 += C::KSTEP) {
              if (!rows_on) break;
              const int kl = sub * KS + k0;  // column in the lambda tile
              if constexpr (sizeof(T) == 4) {
                uint32_t ab[4], as[4];
#pragma unroll
                for (int h = 0; h < 4; ++h)
                  mma::tf32_split(lam_s[(row0 + g + 8 * (h & 1)) * LS + kl + t + 4 * (h >> 1)],
                                  ab[h], as[h]);
#pragma unroll
                for (int i = 0; i < NTW; ++i) {
                  const int nt = ngrp + NGRP * i;
                  if (nt >= ntiles) break;
                  const int u = 2 * nt + (g >> 2), p = g & 3;
                  const T* col = fg + (p >> 1) * C::G_BASE + u * C::FS + (p & 1);
                  uint32_t b0b, b0s, b1b, b1s;
                  mma::tf32_split(col[2 * (k0 + t)], b0b, b0s);
                  mma::tf32_split(col[2 * (k0 + t + 4)], b1b, b1s);
                  float d[4];
                  mma::mma_tf32_16x8x8_zero(d, as, b0b, b1b);
                  mma::mma_tf32_16x8x8(d, ab, b0s, b1s);
                  mma::mma_tf32_16x8x8(d, ab, b0b, b1b);
#pragma unroll
                  for (int r = 0; r < 4; ++r) acc[i][r] += d[r];
                }
              } else {
                const double a0 = lam_s[(row0 + g) * LS + kl + t];
                const double a1 = lam_s[(row0 + g + 8) * LS + kl + t];
#pragma unroll
                for (int i = 0; i < NTW; ++i) {
                  const int nt = ngrp + NGRP * i;
                  if (nt >= ntiles) break;
                  const int u = 2 * nt + (g >> 2), p = g & 3;
                  const T* col = fg + (p >> 1) * C::G_BASE + u * C::FS + (p & 1);
                  mma::dmma_16x8x4(reinterpret_cast<double(&)[4]>(acc[i]), a0, a1,
                                   col[2 * (k0 + t)]);
                }
              }
            }
            __syncthreads();  // before this stage is refilled or the lambda tile rewritten
          }
        }

        // ---- epilogue: rows l0 + row of pos (even t) or neg (odd t) ----
#pragma unroll
        for (int i = 0; i < NTW; ++i) {
          const int nt = ngrp + NGRP * i;
          if (nt >= ntiles) break;
          const int u = 2 * nt + (t >> 1);
          if (u >= nb) continue;
          cpx<T>* o = (t & 1) ? neg : pos;
          const T sc = (t & 1) ? scale_neg : scale_pos;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int l = l0 + row0 + g + 8 * h;
            if (l > lmax) continue;
            const size_t off = ((size_t)(b0 + u) * nm + col) * nl + l;
            cpx<T> v{sc * acc[i][2 * h], sc * acc[i][2 * h + 1]};
            if (r0 > 0) {
              v.re += o[off].re;
              v.im += o[off].im;
            }
            o[off] = v;
          }
        }
      }
    }
  }
}

template <typename T>
int launch(const void* F, const void* G, const double* cos_t, const double* sin_t,
           const double* logpref, const int* sched, int nslots, void* pos, void* neg, int B,
           int nm, int m_lo, int nring, int lmax, double pixarea, cudaStream_t stream) {
  if (B <= 0 || nm <= 0 || nring <= 0) return 0;
  if (m_lo < 0 || m_lo > lmax || nslots < 1 || nslots > 65535 || (B + Cfg<T>::BC - 1) / Cfg<T>::BC > 65535)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t fixed = fixed_smem<T>();
  if ((size_t)optin <= fixed + sizeof(RingState)) return (int)cudaErrorInvalidConfiguration;
  const int rmax = min(nring, (int)(((size_t)optin - fixed) / sizeof(RingState)));
  const size_t smem = fixed + (size_t)rmax * sizeof(RingState);
  e = cudaFuncSetAttribute(legendre_sht_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(nslots, (B + Cfg<T>::BC - 1) / Cfg<T>::BC);
  legendre_sht_kernel<T><<<grid, Cfg<T>::THREADS, smem, stream>>>(
      static_cast<const cpx<T>*>(F), static_cast<const cpx<T>*>(G), cos_t, sin_t, logpref,
      sched, static_cast<cpx<T>*>(pos), static_cast<cpx<T>*>(neg), B, nm, m_lo, nring, lmax,
      rmax, pixarea);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// F, G (B, nm, nring) complex, column j holding m = m_lo + j; cos_t, sin_t
// (nring,), logpref (lmax + 1,) float64; sched (nslots, 2) int32: the
// physical m of each block (-1: none), each in [m_lo, min(m_lo + nm, lmax + 1));
// pos, neg (B, nm, lmax + 1) complex: the transposed outputs, each (b, j) a
// contiguous row over l, so that a block's stores run along l.  Columns that
// no block takes are left as they are.
int legendre_sht_c64(const void* F, const void* G, const double* cos_t, const double* sin_t,
                     const double* logpref, const int* sched, int nslots, void* pos, void* neg,
                     int B, int nm, int m_lo, int nring, int lmax, double pixarea, void* stream) {
  return launch<float>(F, G, cos_t, sin_t, logpref, sched, nslots, pos, neg, B, nm, m_lo, nring,
                       lmax, pixarea, (cudaStream_t)stream);
}

int legendre_sht_c128(const void* F, const void* G, const double* cos_t, const double* sin_t,
                      const double* logpref, const int* sched, int nslots, void* pos, void* neg,
                      int B, int nm, int m_lo, int nring, int lmax, double pixarea,
                      void* stream) {
  return launch<double>(F, G, cos_t, sin_t, logpref, sched, nslots, pos, neg, B, nm, m_lo, nring,
                        lmax, pixarea, (cudaStream_t)stream);
}

}  // extern "C"
