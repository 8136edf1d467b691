// K14: the Legendre stage of the inverse SHT, lambda generated on the fly.
//
// Replaces the JAX programs driftscan_tpu/ops/sht.py:_legendre_chunk (the
// normalised associated Legendre recurrence) and the Legendre contraction of
// _synthesis_real (sht.py:474) and _synthesis_complex (sht.py:535):
//
//   tpos[b, m, r] = sum_{l=m}^{lmax} lambda_lm(theta_r) pos[b, l, m]
//   tneg[b, m, r] = (-1)^m sum_{l=m}^{lmax} lambda_lm(theta_r) a[b, l, -m]
//
// with a[b, l, -m] = neg[b, l, m - 1] for m >= 1 (tneg at m = 0 is zero);
// the negative block is optional (the real form has none).
//
// Per m the stage is one real product, T[ring, col] = sum_l Lambda[ring, l]
// A[l, col], whose columns are the re and im parts of the block's BT units'
// a[:, l, m] (2 BT columns), and in the complex form also of a[:, l, -m]
// (4 BT).  A block owns an m pair (m, nm - 1 - m) of the wrapper's schedule
// (sht.m_schedule), so that every block walks about lmax + 1 multipoles, a
// tile of RT rings and a tile of BT units.  Its 8 warps split the work:
//   * 4 recurrence warps, one ring a thread, run the three-term recurrence
//     in l (float64, the JAX constants and rescaling, legendre_rec.cuh) and
//     write the Lambda tile of the next TL multipoles into shared memory.
//     The recurrence sets the pace, so its step is kept short: the step
//     coefficients come from a table made once on the host (a tile's rows
//     loaded a tile ahead into the warp's shared table), and the steps run
//     in groups of GS (8; 4 in the complex form) without a branch and with
//     no rescale on the chain from one step to the next
//     (legendre::advance: two dependent float64 operations, ~16 cycles,
//     a step); a group in which a mantissa may have left the rescale window
//     is taken again by the branch-free exact step (legendre::exact), so
//     every lambda is step()'s;
//   * 4 product warps, 32 rings each, bring the tile's alm rows (strided
//     16- or 8-byte elements a[b, l, m], from L2) into shared memory by
//     cp.async, one tile ahead, and multiply the Lambda tile by them on the
//     float64 tensor cores (mma.sync m16n8k4; complex64 alm are widened to
//     float64 as the fragments are read) into register accumulators.
// Lambda and the alm rows are double-buffered: the recurrence of tile k + 1
// and the copy of its alm rows run while tile k is multiplied, with one
// block barrier a tile.  After an m's last tile the product warps store its
// outputs, (B, nm, nring), each lane a (re, im) pair: 8 consecutive rings of
// 4 units a store instruction, whole 32-byte sectors.  The sums run in a
// fixed order (tiles in l, k-steps within a tile), so two launches give the
// same bits.  complex64 takes the same path (float64 lambda and sums,
// rounded to float32 as stored).
//
// What bounds it on an H100: operations.  The recurrence, 5 float64 flops a
// lambda on the CUDA cores (34 TFLOP/s), runs beside the product, 2 x 2 B
// (4 B in the complex form) flops a lambda on the float64 tensor cores (67
// TFLOP/s); at B 8, lmax 229, 1023 rings (the timestream's maps) 27.2 M
// lambda, 0.004 ms beside 0.013 ms (0.026 in the complex form), so the
// product's time is the bound.  The alm are read from L2 once per ring
// tile, the outputs written once.  Measured, the recurrence warps still set the
// pace in the real form, the product warps in the complex form, and the
// barrier a tile makes a block wait for its slowest warp's replays
// (PERF.md).
//
// Plain version: driftscan_tpu_torch.ops.sht.legendre_synth_ref.

#include <cuda_runtime.h>
#include <math.h>

#include "legendre_rec.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr int RT = 128;              // rings a block
constexpr int TL = 32;               // multipoles a tile
constexpr int CPAD = 32;             // coefficient rows past lmax (SYNTH_L_TILE in ops/sht.py)
// recurrence steps between rescale checks: a longer group has fewer checks,
// a shorter one a cheaper replay; the complex form's product warps are the
// slower side, and there the replays cost more than the checks
template <bool NEG>
__host__ __device__ constexpr int group_steps() {
  return NEG ? 4 : 8;
}
constexpr int BT = 8;                // units a block
constexpr int MIN_BLOCKS = 2;        // blocks an SM (the register budget)
constexpr int REC_WARPS = RT / 32;   // one ring a thread
constexpr int MMA_WARPS = 4;         // product warps
constexpr int MT = RT / (16 * MMA_WARPS);  // 16-ring tiles a product warp
constexpr int THREADS = 32 * (REC_WARPS + MMA_WARPS);
constexpr int LS = RT + 4;           // doubles a Lambda row: = 4 mod 16, conflict-free A reads
static_assert(TL % 8 == 0 && TL <= CPAD && CPAD <= 32, "whole rescale groups; a lane a row");
static_assert(MT >= 1 && MT * 16 * MMA_WARPS == RT, "product warps cover the ring tile");

template <typename T>
struct cpx {
  T re, im;
};

// one (re, im) pair as one 8- or 16-byte store
__device__ __forceinline__ void store2(cpx<float>* p, float re, float im) {
  *reinterpret_cast<float2*>(p) = make_float2(re, im);
}
__device__ __forceinline__ void store2(cpx<double>* p, double re, double im) {
  *reinterpret_cast<double2*>(p) = make_double2(re, im);
}

// alm tile row stride in T: B-fragment reads of 4 rows x 8 columns fall on
// distinct banks (= 4 mod 16 doubles; = 8 or 24 mod 32 floats)
template <typename T, int NCOL>
__host__ __device__ constexpr int alm_stride() {
  return sizeof(T) == 8 ? NCOL + 4 : NCOL + 8;
}

template <typename T, bool NEG>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr int NCOL = (NEG ? 4 : 2) * BT;
  return 2ull * TL * LS * sizeof(double) + 2ull * TL * alm_stride<T, NCOL>() * sizeof(T);
}

template <typename T, bool NEG>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
legendre_synth_kernel(const cpx<T>* __restrict__ pos, const cpx<T>* __restrict__ neg,
                      const double* __restrict__ cos_t, const double* __restrict__ sin_t,
                      const double* __restrict__ logpref, const double2* __restrict__ coef,
                      const int* __restrict__ sched,
                      cpx<T>* __restrict__ tpos, cpx<T>* __restrict__ tneg, int B, int nm,
                      int nring, int lmax) {
  constexpr int NCOL = (NEG ? 4 : 2) * BT;  // columns: pos units (re, im), then neg units
  constexpr int NT = NCOL / 8;              // 8-column tiles
  constexpr int NTP = 2 * BT / 8;           // of which pos
  constexpr int AS = alm_stride<T, NCOL>();
  constexpr int GS = group_steps<NEG>();
  extern __shared__ __align__(16) unsigned char smem[];
  double* lam_s = reinterpret_cast<double*>(smem);                         // [2][TL][LS]
  T* alm_s = reinterpret_cast<T*>(smem + 2ull * TL * LS * sizeof(double));  // [2][TL][AS]
  __shared__ double2 coef_s[REC_WARPS * TL];  // each recurrence warp's (a, b) of its tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool rec = warp < REC_WARPS;
  const int nl = lmax + 1;
  const int ring0 = blockIdx.y * RT;
  const int b0 = blockIdx.z * BT;
  const int nbu = min(BT, B - b0);  // units of this block

  // the block's tiles: those of m1, then those of m2 (-1: none)
  const int m1 = sched[2 * blockIdx.x], m2 = sched[2 * blockIdx.x + 1];
  const int n1 = (nl - m1 + TL - 1) / TL;
  const int n2 = m2 >= 0 ? (nl - m2 + TL - 1) / TL : 0;
  const int ntile = n1 + n2;
  auto tile_m = [&](int k) { return k < n1 ? m1 : m2; };
  auto tile_l0 = [&](int k) { return k < n1 ? m1 + k * TL : m2 + (k - n1) * TL; };

  // ---- recurrence warps: one ring a thread ----
  const int ring = ring0 + warp * 32 + lane;  // this thread's ring (recurrence warps)
  const bool ring_on = rec && ring < nring;
  const double x = ring_on ? cos_t[ring] : 0.0;
  legendre::State st;
  // the lane's step coefficients (a, b) of tile k, at l0 + lane
  auto coef_row = [&](int k) {
    return __ldg(coef + (size_t)tile_m(k) * (nl + CPAD) + tile_l0(k) + lane);
  };
  double2 cnext = make_double2(0.0, 0.0);  // tile k's, loaded a tile ahead
  if (rec && lane < TL) cnext = coef_row(0);

  // Lambda rows [l0, l0 + TL) of this thread's ring into buffer buf (zeros
  // past lmax; a ring past nring gets finite values that reach no output).
  // The step coefficients of the tile's rows come from the warp's table in
  // shared memory.  The first tile of an m takes its first GS rows by step()
  // (the seed, l = m + 1) and exact(); the other rows go in groups of GS
  // branch-free steps (legendre::advance), and a group in which any lane's
  // mantissas may have left the window (a possible rescale; rare, since a
  // chain rescales only where its lambda crosses 30 decades) is taken again
  // from its start by legendre::exact, so that every lambda is exactly
  // step()'s.
  auto produce = [&](int k, int buf) {
    const int m = tile_m(k), l0 = tile_l0(k);
    double2* cf = coef_s + warp * TL;
    __syncwarp();  // the previous tile's table is read
    if (lane < TL) cf[lane] = cnext;
    __syncwarp();
    if (k + 1 < ntile && lane < TL) cnext = coef_row(k + 1);
    const int nlc = min(TL, nl - l0);
    double* dst = lam_s + (size_t)buf * TL * LS + warp * 32 + lane;
    auto put = [&](int li, double lam) { dst[li * LS] = li < nlc ? lam : 0.0; };
    int li0 = 0;
    if (l0 == m) {
      const double mf = (double)m;
      const double sgn = (m % 2 == 0) ? 1.0 : -1.0;
      const double sq = sqrt(2.0 * mf + 3.0);
      const double sin_r = ring_on ? sin_t[ring] : 1.0;
#pragma unroll
      for (int li = 0; li < GS; ++li) {
        const double2 c = cf[li];
        put(li, li < 2 ? legendre::step(st, l0 + li, m, mf, x, sin_r, c.x, c.y, sgn, sq, logpref)
                       : legendre::exact(st, x, c.x, c.y));
      }
      li0 = GS;
    }
    for (int li = li0; li < TL; li += GS) {
      const double u0 = st.u0, u1 = st.u1;
      double2 c[GS];  // the group's coefficients, loaded before its stores
#pragma unroll
      for (int g = 0; g < GS; ++g) c[g] = cf[li + g];
      bool moved = false;
#pragma unroll
      for (int g = 0; g < GS; ++g) {
        legendre::advance(st, moved, x, c[g].x, c[g].y);
        put(li + g, legendre::lambda(st));
      }
      if (__any_sync(0xffffffffu, moved)) {
        st.u0 = u0;
        st.u1 = u1;
#pragma unroll
        for (int g = 0; g < GS; ++g) put(li + g, legendre::exact(st, x, c[g].x, c[g].y));
      }
    }
  };

  // ---- product warps: 32 rings each, all NCOL columns ----
  const int pw = warp - REC_WARPS;          // product warp index
  const int g = lane >> 2, t = lane & 3;    // mma fragment coordinates
  const int pt = tid - 32 * REC_WARPS;      // product thread index
  double acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0;

  // the alm rows of tile k into buffer buf: element (li, column pair c) is
  // unit c % BT of the pos (c < BT) or neg block at l0 + li
  auto fetch = [&](int k, int buf) {
    const int m = tile_m(k), l0 = tile_l0(k);
    T* dst = alm_s + (size_t)buf * TL * AS;
    for (int e = pt; e < TL * (NCOL / 2); e += 32 * MMA_WARPS) {
      const int li = e / (NCOL / 2), c = e - li * (NCOL / 2);
      const int u = c % BT, l = l0 + li;
      const bool negc = NEG && c >= BT;
      const bool ok = l <= lmax && u < nbu && (!negc || m > 0);
      const size_t row = (size_t)(b0 + u) * nl + l;
      const cpx<T>* src = pos;
      if (ok) src = negc ? neg + row * (nm - 1) + (m - 1) : pos + row * nm + m;
      mma::cp_async<sizeof(cpx<T>)>(dst + li * AS + 2 * c, src, ok);
    }
    mma::cp_async_commit();
  };

  auto consume = [&](int k, int buf) {
    const int nlc = min(TL, nl - tile_l0(k));
    const int kend = (nlc + 3) & ~3;
    const double* lam = lam_s + (size_t)buf * TL * LS + pw * 16 * MT;
    const T* alm = alm_s + (size_t)buf * TL * AS;
#pragma unroll
    for (int k0 = 0; k0 < TL; k0 += 4) {
      if (k0 >= kend) break;
      const double* la = lam + (k0 + t) * LS + g;
      double a0[MT], a1[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        a0[i] = la[16 * i];
        a1[i] = la[16 * i + 8];
      }
      const T* ab = alm + (k0 + t) * AS + g;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if ((j % NTP) * 4 >= nbu) continue;  // columns past the block's units
        const double bv = (double)ab[8 * j];
#pragma unroll
        for (int i = 0; i < MT; ++i) mma::dmma_16x8x4(acc[i][j], a0[i], a1[i], bv);
      }
    }
  };

  // m's outputs of this warp's rings: c0, c1 = (re, im) of ring g, unit
  // (j % NTP) * 4 + t; c2, c3 the same at ring g + 8
  auto store = [&](int m) {
    const double nsgn = (m % 2 == 0) ? 1.0 : -1.0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int u = (j % NTP) * 4 + t;
      const bool negc = j >= NTP;
      cpx<T>* out = negc ? tneg : tpos;
      const double s = negc ? nsgn : 1.0;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = ring0 + pw * 16 * MT + 16 * i + g + 8 * h;
          if (u < nbu && r < nring)
            store2(out + ((size_t)(b0 + u) * nm + m) * nring + r, (T)(s * acc[i][j][2 * h]),
                   (T)(s * acc[i][j][2 * h + 1]));
          acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0.0;
        }
      }
    }
  };

  if (rec) produce(0, 0);
  else fetch(0, 0);
  for (int k = 0; k < ntile; ++k) {
    if (!rec) mma::cp_async_wait<0>();
    __syncthreads();  // tile k's Lambda and alm in place; tile k - 1's buffers free
    if (rec) {
      if (k + 1 < ntile) produce(k + 1, (k + 1) & 1);
    } else {
      if (k + 1 < ntile) fetch(k + 1, (k + 1) & 1);
      consume(k, k & 1);
      if (k == n1 - 1 || k == ntile - 1) store(tile_m(k));
    }
  }
}

template <typename T, bool NEG>
int launch_form(const void* pos, const void* neg, const double* cos_t, const double* sin_t,
                const double* logpref, const void* coef, const int* sched, int nslots,
                void* tpos, void* tneg, int B, int nm, int nring, int lmax,
                cudaStream_t stream) {
  auto kernel = legendre_synth_kernel<T, NEG>;
  constexpr size_t smem = smem_bytes<T, NEG>();
  // the shared-memory opt-in, once per device
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= 64 || !smem_set[dev])) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess && dev < 64) smem_set[dev] = true;
  }
  if (e != cudaSuccess) return (int)e;
  dim3 grid(nslots, (nring + RT - 1) / RT, (B + BT - 1) / BT);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const cpx<T>*>(pos), static_cast<const cpx<T>*>(neg), cos_t, sin_t, logpref,
      static_cast<const double2*>(coef), sched, static_cast<cpx<T>*>(tpos),
      static_cast<cpx<T>*>(tneg), B, nm, nring, lmax);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* pos, const void* neg, const double* cos_t, const double* sin_t,
           const double* logpref, const void* coef, const int* sched, int nslots, void* tpos,
           void* tneg, int B, int nm, int nring, int lmax, cudaStream_t stream) {
  if (B <= 0 || nm <= 0 || nring <= 0) return 0;
  if (nm > lmax + 1 || nslots != (nm + 1) / 2 || (nring + RT - 1) / RT > 65535 ||
      (B + BT - 1) / BT > 65535)
    return (int)cudaErrorInvalidValue;
  if (neg != nullptr)
    return launch_form<T, true>(pos, neg, cos_t, sin_t, logpref, coef, sched, nslots, tpos,
                                tneg, B, nm, nring, lmax, stream);
  return launch_form<T, false>(pos, nullptr, cos_t, sin_t, logpref, coef, sched, nslots, tpos,
                               nullptr, B, nm, nring, lmax, stream);
}

}  // namespace

extern "C" {

// pos (B, lmax + 1, nm) and neg (B, lmax + 1, nm - 1) complex (neg and tneg
// null: the real form, no negative-m block); cos_t, sin_t (nring,),
// logpref (lmax + 1,) float64; coef (nm, lmax + 1 + CPAD, 2) float64, the step
// coefficients (a, b) of each (m, l) (ops/sht.py step_coefficients); sched
// (nslots, 2) int32, nslots = ceil(nm / 2): the m pair of each block (-1:
// none); tpos, tneg (B, nm, nring) complex.
int legendre_synth_c64(const void* pos, const void* neg, const double* cos_t,
                       const double* sin_t, const double* logpref, const void* coef,
                       const int* sched, int nslots, void* tpos, void* tneg, int B, int nm,
                       int nring, int lmax, void* stream) {
  return launch<float>(pos, neg, cos_t, sin_t, logpref, coef, sched, nslots, tpos, tneg, B, nm,
                       nring, lmax, (cudaStream_t)stream);
}

int legendre_synth_c128(const void* pos, const void* neg, const double* cos_t,
                        const double* sin_t, const double* logpref, const void* coef,
                        const int* sched, int nslots, void* tpos, void* tneg, int B, int nm,
                        int nring, int lmax, void* stream) {
  return launch<double>(pos, neg, cos_t, sin_t, logpref, coef, sched, nslots, tpos, tneg, B,
                        nm, nring, lmax, (cudaStream_t)stream);
}

}  // extern "C"
