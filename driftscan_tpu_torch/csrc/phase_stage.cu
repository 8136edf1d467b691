// K4: the phase stage of the SHT (k4_phase) and its inverse (k4_phase_inv).
//
// Replaces the phase stage of the JAX programs driftscan_tpu/ops/sht.py:
// _analysis (sht.py:433-446) and _analysis_split's belt/cap projection
// (sht.py:664-727) for the forward stage,
//
//   F[b, m, r] = sum_{j < N_r} f[b, r, j] e^{-i m phi_rj}
//   G[b, m, r] = sum_{j < N_r} f[b, r, j] e^{+i m phi_rj}
//
// for m = m0 .. m0 + nm - 1, and the phase stage of _synthesis_real
// (sht.py:506-519), _synthesis_complex (sht.py:563-577) and
// _phase_unproject (sht.py:809) for the inverse,
//
//   f[b, r, j] = sum_{m < nm} w_m T+[b, m, r] e^{+i m phi_rj}
//                (+ T-[b, m, r] e^{-i m phi_rj} for a complex field)
//
// with w_0 = 1, w_{m>0} = 2 and the real part for a real field (w = 1
// otherwise), padding slots j >= N_r written as zeros.  Ring r holds N_r
// pixels at phi_rj = pi (2 j + h_r) / N_r, h_r in {0, 1}.
//
// As in the JAX package, the stage is a projection onto the requested m
// only, not an FFT: the rings that share N and h (a polar cap's pair i and
// 4 nside - i, or one parity of the equatorial belt, whose 2 nside + 1
// rings of 4 nside pixels alternate h = 1, 0) share one table of
// cos / sin(m phi_j), so each group of rings is one real product,
// rows (unit, ring) x pixels times pixels x m (forward) or rows x m times
// m x pixels (inverse), with the table generated in shared memory a tile
// at a time and shared by every row of the tile.  The angle is reduced in
// integers as the JAX package's _phase_angle_tables (sht.py:211) does,
// t = m (2 j + h) mod 2 N exactly (the first product of a thread in 64
// bits, then steps of an exact modular add), and evaluated as
// sincospi(t / N) in the table's type: the true m in the polar caps, where
// m exceeds N_r, and full accuracy at any m.
//
// Forward: a block owns FR rows of one group and FM m; it walks the
// group's pixels in stages of JC (32 complex64, 16 complex128): the
// stage's maps (rows x JC, each row a coalesced run of the ring) and its
// table (JC x FM) go to shared memory, then every thread adds its 4 rows x
// 2 m of P = sum f cos and Q = sum f sin by fused multiply-adds on the
// CUDA cores (F = P - iQ, G = P + iQ); in float32 each stage is summed from
// zero and then added to the running total, which keeps the result no
// farther from the float64 truth than the FFT route's.  Each output (b, m,
// r) is summed over j = 0 .. N_r - 1 in the same order whatever block or
// column computes it, so a window's columns equal the full range's bit for
// bit and two launches give the same bits; no atomics.  Inverse: a block
// owns IR rows and IJ pixels and walks m in stages of MC (float32 staged
// the same way); every thread adds its 2 rows x 4 pixels over m = 0 ..
// nm - 1 in order.  A warp whose rows all lie past the group's, or whose m
// (pixels) all lie past the call's (the ring's), skips the arithmetic.
// One launch a call, the tile list (group, first row) made by the wrapper
// (ops/sht.py phase_tiles).
//
// What bounds it on an H100: at the path's shapes, operations -- 8 real
// flops a (unit, pixel, m) (4 in the inverse's real form) on the float32
// (float64) CUDA cores, beside one sincospi a (m, pixel, group) and row
// tile; the maps are read once per m tile (the m tiles of a row tile run
// side by side, so the repeats come from L2).  The bytes (maps read once,
// F and G written once) bound it where nm is small.  The design keeps the
// arithmetic on the CUDA cores in the input's type; measured at 0.15-0.19
// of the card's bound (PERF.md), with the belt's product on the tensor
// cores (3xTF32, float64 mma.sync) and a per-group sincos table as the
// next steps.
//
// Plain versions: driftscan_tpu_torch.ops.sht.phase_stage_ref and
// phase_stage_inv_ref (one FFT a ring length, the JAX package's bins).

#include <cuda_runtime.h>
#include <limits.h>

namespace {

template <typename T> struct cpx_of;
template <> struct cpx_of<float> { using type = float2; };
template <> struct cpx_of<double> { using type = double2; };
template <typename T> using cpx = typename cpx_of<T>::type;

constexpr int THREADS = 256;
constexpr int GF = 5;  // a group row: N, h, rings, first ring, ring stride

// forward: FR rows x FM m a block; a thread 4 rows x 2 m, a warp 16 x 16,
// the 8 warps 4 (rows) x 2 (m)
constexpr int FR = 64;  // PHASE_ROWS in ops/sht.py
constexpr int FM = 32;
constexpr int FTR = 4;
constexpr int FTM = 2;
// inverse: IR rows x IJ pixels a block; a thread 2 rows x 4 pixels, a warp
// 16 x 16, the 8 warps 2 (rows) x 4 (pixels)
constexpr int IR = 32;  // PHASE_INV_ROWS in ops/sht.py
constexpr int IJ = 64;
constexpr int ITR = 2;
constexpr int ITJ = 4;
static_assert((FR / FTR) * (FM / FTM) == THREADS && FR / FTR == 16 && FM / FTM == 16,
              "the forward's warps are 4 x 2 tiles of 16 rows x 16 m");
static_assert((IR / ITR) * (IJ / ITJ) == THREADS && IR == 32 && IJ / ITJ == 16 && ITJ == 4,
              "the inverse's warps are 2 x 4 tiles of 16 rows x 16 pixels");

// pixels (forward) or m (inverse) a stage
template <typename T> struct Depth { static constexpr int v = 32; };
template <> struct Depth<double> { static constexpr int v = 16; };
// float32 sums each stage from zero and adds it to the running total (a
// running float32 sum of 4 nside terms lands ~4x farther from the float64
// truth than the FFT route; staged, no farther)
template <typename T> struct Staged { static constexpr bool v = true; };
template <> struct Staged<double> { static constexpr bool v = false; };
// blocks an SM the registers must leave room for
constexpr int FWD_BLOCKS = 2;
constexpr int INV_BLOCKS = 3;

__device__ __forceinline__ void sin_cos_pi(float x, float* s, float* c) { sincospif(x, s, c); }
__device__ __forceinline__ void sin_cos_pi(double x, double* s, double* c) { sincospi(x, s, c); }

__device__ __forceinline__ void ld2(const float* p, float (&v)[2]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void ld2(const double* p, double (&v)[2]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void st2(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void st2(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(double* p, const double (&v)[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// (a + b) mod n for a, b < n <= 2^31
__device__ __forceinline__ unsigned add_mod(unsigned a, unsigned b, unsigned n) {
  const unsigned s = a + b;
  return s >= n ? s - n : s;
}

// row q of a group: unit q / rings and the group's (q % rings)-th ring
struct Row {
  int b, ring;
};
__device__ __forceinline__ Row group_row(int q, int nr, int first, int stride) {
  const int b = q / nr;
  return {b, first + (q - b * nr) * stride};
}

template <typename T>
__global__ void __launch_bounds__(THREADS, FWD_BLOCKS)
    phase_fwd_kernel(const cpx<T>* __restrict__ maps, const int* __restrict__ groups,
                     const int2* __restrict__ tiles, cpx<T>* __restrict__ F,
                     cpx<T>* __restrict__ G, int B, int nring, int maxlen, int m0, int nm,
                     int nmt) {
  constexpr int JC = Depth<T>::v;
  constexpr int XP = FR + 4;                 // padded row of the staged maps (16-byte rows)
  constexpr int XLOADS = FR * JC / THREADS;  // staged map elements a thread
  constexpr int XROWS = THREADS / JC;        // rows a pass of the block
  constexpr int TLOADS = JC * FM / THREADS;  // table entries a thread
  constexpr int TSTEP = THREADS / FM;        // pixels between a thread's entries
  __shared__ __align__(16) T xr[JC][XP];
  __shared__ __align__(16) T xi[JC][XP];
  __shared__ __align__(16) T cs[JC][FM];
  __shared__ __align__(16) T sn[JC][FM];

  const int2 tile = tiles[blockIdx.x / nmt];
  const int col0 = (blockIdx.x % nmt) * FM;  // the tile's first column (m = m0 + col0)
  const int* gr = groups + GF * tile.x;
  const int N = gr[0], h = gr[1], nr = gr[2], first = gr[3], stride = gr[4];
  const int nrows = B * nr;
  const int row0 = tile.y;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 1, wm = warp & 1;
  const int rl = wr * 16 + (lane >> 3) * FTR;  // the thread's first row in the tile
  const int ml = wm * 16 + (lane & 7) * FTM;   // its first column in the tile
  const bool active = row0 + wr * 16 < nrows && col0 + wm * 16 < nm;

  // the rows this thread stages: element e = tid + THREADS k is row
  // e / JC, pixel e % JC of the stage
  const int xj = tid % JC;
  long long xoff[XLOADS];
#pragma unroll
  for (int k = 0; k < XLOADS; ++k) {
    const int q = row0 + tid / JC + XROWS * k;
    if (q < nrows) {
      const Row w = group_row(q, nr, first, stride);
      xoff[k] = ((long long)w.b * nring + w.ring) * maxlen + xj;
    } else {
      xoff[k] = -1;
    }
  }

  // the table entries this thread makes: column tm, pixels tj + TSTEP k;
  // t = m (2 j + h) mod 2N, stepped exactly in unsigned integers
  const int tm = tid % FM, tj = tid / FM;
  const unsigned n2 = 2u * (unsigned)N;
  const unsigned mm = (unsigned)(((long long)m0 + col0 + tm) % n2);
  const unsigned tstep = (unsigned)((2ull * TSTEP * mm) % n2);
  const unsigned sstep = (unsigned)((2ull * JC * mm) % n2);
  unsigned tbase = (unsigned)(((unsigned long long)mm * (2u * tj + (unsigned)h)) % n2);
  const T nf = T(N);

  // the sums (P re, P im, Q re, Q im) of each (row, m); acc the stage's
  // (float32) or the running sum (float64)
  T acc[4][FTR][FTM], sum[4][FTR][FTM];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < FTR; ++i)
#pragma unroll
      for (int k = 0; k < FTM; ++k) {
        acc[c][i][k] = T(0);
        if constexpr (Staged<T>::v) sum[c][i][k] = T(0);
      }
  T (&fin)[4][FTR][FTM] = Staged<T>::v ? sum : acc;

  for (int j0 = 0; j0 < N; j0 += JC) {
#pragma unroll
    for (int k = 0; k < XLOADS; ++k) {
      const int rr = tid / JC + XROWS * k;
      cpx<T> v;
      v.x = T(0);
      v.y = T(0);
      if (xoff[k] >= 0 && j0 + xj < N) v = maps[xoff[k] + j0];
      xr[xj][rr] = v.x;
      xi[xj][rr] = v.y;
    }
    unsigned t = tbase;
#pragma unroll
    for (int k = 0; k < TLOADS; ++k) {
      const int jj = tj + TSTEP * k;
      T s = T(0), c = T(0);
      if (j0 + jj < N) sin_cos_pi(T(t) / nf, &s, &c);
      cs[jj][tm] = c;
      sn[jj][tm] = s;
      t = add_mod(t, tstep, n2);
    }
    tbase = add_mod(tbase, sstep, n2);
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int jj = 0; jj < JC; ++jj) {
        T ar[FTR], ai[FTR], c[FTM], s[FTM];
        ld4(&xr[jj][rl], ar);
        ld4(&xi[jj][rl], ai);
        ld2(&cs[jj][ml], c);
        ld2(&sn[jj][ml], s);
#pragma unroll
        for (int i = 0; i < FTR; ++i)
#pragma unroll
          for (int k = 0; k < FTM; ++k) {
            acc[0][i][k] = fma(ar[i], c[k], acc[0][i][k]);
            acc[1][i][k] = fma(ai[i], c[k], acc[1][i][k]);
            acc[2][i][k] = fma(ar[i], s[k], acc[2][i][k]);
            acc[3][i][k] = fma(ai[i], s[k], acc[3][i][k]);
          }
      }
      if constexpr (Staged<T>::v) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int i = 0; i < FTR; ++i)
#pragma unroll
            for (int k = 0; k < FTM; ++k) {
              sum[c][i][k] += acc[c][i][k];
              acc[c][i][k] = T(0);
            }
      }
    }
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < FTR; ++i) {
    const int q = row0 + rl + i;
    if (q >= nrows) continue;
    const Row w = group_row(q, nr, first, stride);
#pragma unroll
    for (int k = 0; k < FTM; ++k) {
      const int col = col0 + ml + k;
      if (col >= nm) continue;
      const size_t o = ((size_t)w.b * nm + col) * nring + w.ring;
      const T pr = fin[0][i][k], pi = fin[1][i][k], qr = fin[2][i][k], qi = fin[3][i][k];
      cpx<T> f, g;
      f.x = pr + qi;
      f.y = pi - qr;
      g.x = pr - qi;
      g.y = pi + qr;
      F[o] = f;
      G[o] = g;
    }
  }
}

template <typename T, bool REAL>
__global__ void __launch_bounds__(THREADS, INV_BLOCKS)
    phase_inv_kernel(const cpx<T>* __restrict__ tpos, const cpx<T>* __restrict__ tneg,
                     const int* __restrict__ groups, const int2* __restrict__ tiles,
                     T* __restrict__ out, int B, int nring, int maxlen, int nm, int njt) {
  constexpr int MC = Depth<T>::v;
  constexpr int CW = REAL ? 2 : 4;           // (w T re, w T im) or (A re, A im, D re, D im)
  constexpr int CLOADS = MC * IR / THREADS;  // coefficient entries a thread
  constexpr int CSTEP = THREADS / IR;        // m between them
  constexpr int TLOADS = MC * IJ / THREADS;  // table entries a thread
  constexpr int TSTEP = THREADS / IJ;        // m between them
  constexpr int OW = REAL ? 1 : 2;           // T values an output element
  __shared__ __align__(16) T co[MC][IR][CW];
  __shared__ __align__(16) T cs[MC][IJ];
  __shared__ __align__(16) T sn[MC][IJ];

  const int2 tile = tiles[blockIdx.x / njt];
  const int j0 = (blockIdx.x % njt) * IJ;
  const int* gr = groups + GF * tile.x;
  const int N = gr[0], h = gr[1], nr = gr[2], first = gr[3], stride = gr[4];
  const int nrows = B * nr;
  const int row0 = tile.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (j0 >= N) {  // padding slots only
    for (int e = tid; e < IR * IJ; e += THREADS) {
      const int q = row0 + e / IJ, j = j0 + e % IJ;
      if (q >= nrows || j >= maxlen) continue;
      const Row w = group_row(q, nr, first, stride);
      T* o = out + (((size_t)w.b * nring + w.ring) * maxlen + j) * OW;
      o[0] = T(0);
      if constexpr (!REAL) o[1] = T(0);
    }
    return;
  }

  const int wr = warp >> 2, wj = warp & 3;
  const int rl = wr * 16 + (lane >> 2) * ITR;  // the thread's first row in the tile
  const int jl = wj * 16 + (lane & 3) * ITJ;   // its first pixel in the tile
  const bool active = row0 + wr * 16 < nrows && j0 + wj * 16 < N;

  // the coefficient row this thread stages (row tid % IR, m tid / IR +
  // CSTEP k of a stage)
  const int cr = tid % IR, cm = tid / IR;
  long long coff = -1;
  if (row0 + cr < nrows) {
    const Row w = group_row(row0 + cr, nr, first, stride);
    coff = (long long)w.b * nm * nring + w.ring;
  }

  // the table entries this thread makes: pixel ej, m em + TSTEP k;
  // t = m (2 j + h) mod 2N, stepped exactly in unsigned integers
  const int ej = tid % IJ, em = tid / IJ;
  const unsigned n2 = 2u * (unsigned)N;
  const unsigned kj = (unsigned)((2ll * (j0 + ej) + h) % n2);
  const unsigned tstep = (unsigned)(((unsigned long long)TSTEP * kj) % n2);
  const unsigned sstep = (unsigned)(((unsigned long long)MC * kj) % n2);
  unsigned tbase = (unsigned)(((unsigned long long)em * kj) % n2);
  const T nf = T(N);
  const bool in_ring = j0 + ej < N;

  // the sums (re, im) of each (row, pixel): acc the stage's (float32) or
  // the running sum (float64)
  T acc[2][ITR][ITJ], sum[2][ITR][ITJ];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < ITR; ++i)
#pragma unroll
      for (int k = 0; k < ITJ; ++k) {
        acc[c][i][k] = T(0);
        if constexpr (Staged<T>::v) sum[c][i][k] = T(0);
      }
  T (&fin)[2][ITR][ITJ] = Staged<T>::v ? sum : acc;

  for (int mc0 = 0; mc0 < nm; mc0 += MC) {
#pragma unroll
    for (int k = 0; k < CLOADS; ++k) {
      const int mi = cm + CSTEP * k, m = mc0 + mi;
      T v[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) v[c] = T(0);
      if (coff >= 0 && m < nm) {
        const cpx<T> p = tpos[coff + (long long)m * nring];
        if constexpr (REAL) {
          const T w = m == 0 ? T(1) : T(2);  // exact: the sum keeps its bits
          v[0] = w * p.x;
          v[1] = w * p.y;
        } else {
          const cpx<T> n = tneg[coff + (long long)m * nring];
          v[0] = p.x + n.x;
          v[1] = p.y + n.y;
          v[2] = p.x - n.x;
          v[3] = p.y - n.y;
        }
      }
      if constexpr (REAL) st2(&co[mi][cr][0], v);
      else st4(&co[mi][cr][0], v);
    }
    unsigned t = tbase;
#pragma unroll
    for (int k = 0; k < TLOADS; ++k) {
      const int mi = em + TSTEP * k;
      T s = T(0), c = T(0);
      if (in_ring && mc0 + mi < nm) sin_cos_pi(T(t) / nf, &s, &c);
      cs[mi][ej] = c;
      sn[mi][ej] = s;
      t = add_mod(t, tstep, n2);
    }
    tbase = add_mod(tbase, sstep, n2);
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int mi = 0; mi < MC; ++mi) {
        T c[ITJ], s[ITJ];
        ld4(&cs[mi][jl], c);
        ld4(&sn[mi][jl], s);
#pragma unroll
        for (int i = 0; i < ITR; ++i) {
          if constexpr (REAL) {
            T v[2];
            ld2(&co[mi][rl + i][0], v);
#pragma unroll
            for (int k = 0; k < ITJ; ++k) {
              acc[0][i][k] = fma(v[0], c[k], acc[0][i][k]);
              acc[0][i][k] = fma(-v[1], s[k], acc[0][i][k]);
            }
          } else {
            T v[4];
            ld4(&co[mi][rl + i][0], v);
#pragma unroll
            for (int k = 0; k < ITJ; ++k) {
              acc[0][i][k] = fma(v[0], c[k], acc[0][i][k]);
              acc[0][i][k] = fma(-v[3], s[k], acc[0][i][k]);
              acc[1][i][k] = fma(v[1], c[k], acc[1][i][k]);
              acc[1][i][k] = fma(v[2], s[k], acc[1][i][k]);
            }
          }
        }
      }
      if constexpr (Staged<T>::v) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int i = 0; i < ITR; ++i)
#pragma unroll
            for (int k = 0; k < ITJ; ++k) {
              sum[c][i][k] += acc[c][i][k];
              acc[c][i][k] = T(0);
            }
      }
    }
    __syncthreads();
  }

  // every valid (row, pixel) of the tile is written, the ring's padding
  // slots as zeros (a thread's 4 pixels lie all inside or all past N, a
  // multiple of 4)
  const int j = j0 + jl;
  if (j >= maxlen) return;
  const bool inside = j < N;
#pragma unroll
  for (int i = 0; i < ITR; ++i) {
    const int q = row0 + rl + i;
    if (q >= nrows) continue;
    const Row w = group_row(q, nr, first, stride);
    T* o = out + (((size_t)w.b * nring + w.ring) * maxlen + j) * OW;
    if constexpr (REAL) {
      T r[4];
#pragma unroll
      for (int k = 0; k < ITJ; ++k) r[k] = inside ? fin[0][i][k] : T(0);
      st4(o, r);
    } else {
#pragma unroll
      for (int k = 0; k < ITJ; k += 2) {
        T r[4];
        r[0] = inside ? fin[0][i][k] : T(0);
        r[1] = inside ? fin[1][i][k] : T(0);
        r[2] = inside ? fin[0][i][k + 1] : T(0);
        r[3] = inside ? fin[1][i][k + 1] : T(0);
        st4(o + 2 * k, r);
      }
    }
  }
}

template <typename T>
int launch_fwd(const void* maps, const int* groups, const int* tiles, int ntiles, void* F,
               void* G, int B, int nring, int maxlen, int m0, int nm, int rows,
               cudaStream_t stream) {
  if (rows != FR || B < 0 || nm < 0 || m0 < 0 || ntiles < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || nm == 0 || ntiles == 0) return 0;
  const int nmt = (nm + FM - 1) / FM;
  if ((long long)ntiles * nmt > INT_MAX) return (int)cudaErrorInvalidValue;
  phase_fwd_kernel<T><<<ntiles * nmt, THREADS, 0, stream>>>(
      static_cast<const cpx<T>*>(maps), groups, reinterpret_cast<const int2*>(tiles),
      static_cast<cpx<T>*>(F), static_cast<cpx<T>*>(G), B, nring, maxlen, m0, nm, nmt);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_inv(const void* tpos, const void* tneg, const int* groups, const int* tiles,
               int ntiles, void* out, int B, int nring, int maxlen, int nm, int rows, int real,
               cudaStream_t stream) {
  if (rows != IR || B < 0 || nm < 0 || ntiles < 0 || maxlen % 4 != 0 ||
      (real != 0) != (tneg == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || ntiles == 0) return 0;
  const int njt = (maxlen + IJ - 1) / IJ;
  if ((long long)ntiles * njt > INT_MAX) return (int)cudaErrorInvalidValue;
  const cpx<T>* p = static_cast<const cpx<T>*>(tpos);
  const int2* tl = reinterpret_cast<const int2*>(tiles);
  if (real)
    phase_inv_kernel<T, true><<<ntiles * njt, THREADS, 0, stream>>>(
        p, nullptr, groups, tl, static_cast<T*>(out), B, nring, maxlen, nm, njt);
  else
    phase_inv_kernel<T, false><<<ntiles * njt, THREADS, 0, stream>>>(
        p, static_cast<const cpx<T>*>(tneg), groups, tl, static_cast<T*>(out), B, nring,
        maxlen, nm, njt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// maps (B, nring, maxlen) complex, padding slots not read; groups (ngroups,
// 5) int32 rows (N, h, rings, first ring, ring stride) and tiles (ntiles, 2)
// int32 (group, first row) of ops/sht.py phase_groups / phase_tiles, rows a
// tile = FR; F, G (B, nm, nring) complex for m = m0 .. m0 + nm - 1.
int phase_fwd_c64(const void* maps, const int* groups, const int* tiles, int ntiles, void* F,
                  void* G, int B, int nring, int maxlen, int m0, int nm, int rows,
                  void* stream) {
  return launch_fwd<float>(maps, groups, tiles, ntiles, F, G, B, nring, maxlen, m0, nm, rows,
                           (cudaStream_t)stream);
}

int phase_fwd_c128(const void* maps, const int* groups, const int* tiles, int ntiles, void* F,
                   void* G, int B, int nring, int maxlen, int m0, int nm, int rows,
                   void* stream) {
  return launch_fwd<double>(maps, groups, tiles, ntiles, F, G, B, nring, maxlen, m0, nm, rows,
                            (cudaStream_t)stream);
}

// tpos, tneg (B, nm, nring) complex for m = 0 .. nm - 1 (tneg null: the
// real form); groups and tiles as above, rows a tile = IR; out (B, nring,
// maxlen), real (real form) or complex, every slot written.
int phase_inv_c64(const void* tpos, const void* tneg, const int* groups, const int* tiles,
                  int ntiles, void* out, int B, int nring, int maxlen, int nm, int rows,
                  int real, void* stream) {
  return launch_inv<float>(tpos, tneg, groups, tiles, ntiles, out, B, nring, maxlen, nm, rows,
                           real, (cudaStream_t)stream);
}

int phase_inv_c128(const void* tpos, const void* tneg, const int* groups, const int* tiles,
                   int ntiles, void* out, int B, int nring, int maxlen, int nm, int rows,
                   int real, void* stream) {
  return launch_inv<double>(tpos, tneg, groups, tiles, ntiles, out, B, nring, maxlen, nm, rows,
                            real, (cudaStream_t)stream);
}

}  // extern "C"
