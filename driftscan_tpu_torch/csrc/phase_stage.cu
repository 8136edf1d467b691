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
// only, not an FFT.  The rings that share N and h (a polar cap's pair i and
// 4 nside - i, or one parity of the equatorial belt) share one table, so
// each group of rings is one real product:
//   forward  (rows (unit, ring) x {re, im}) x pixels  times  pixels x
//            (m x {cos, sin}): P = sum f cos, Q = sum f sin, F = P - iQ,
//            G = P + iQ;
//   inverse  (rows x {re, im}) x (m x {cos, sin})  times  (m x {cos, sin})
//            x pixels, the coefficients with w_m applied and the sign of
//            the sine folded in (A = T+ + T-, D = T+ - T-: re = A_re cos -
//            D_im sin, im = A_im cos + D_re sin).
// Every angle is pi t / N with t reduced exactly in unsigned integers mod
// 2N (the JAX package's _phase_angle_tables, sht.py:211): the true m in the
// polar caps, where m exceeds N_r, and full accuracy at any m.  Its cosine
// and sine are read from the group's half-wave table cos(pi u / N), u = 0
// .. N, one cospi an entry a block (sin(pi t / N) = cos(pi (t - N/2) / N),
// cos(pi t / N) = cos(pi (2N - t) / N): exact index maps), so each value is
// a function of (t, N) alone.
//
// What bounds it on an H100 (PERF.md has each shape's numbers): the
// product's 8 flops a (unit, pixel, m) (4 in the inverse's real form) on
// the tensor cores -- 3xTF32 at 495 / 3 TFLOP/s in complex64, float64 at
// 67 TFLOP/s in complex128 -- where nm is large ([slice] and [pol] chunks,
// [dish], the timestream's inverse); the maps read once, F and G written
// once, at 3.35 TB/s where nm is small (the [ns2 window], ns1b).
//
// The forward's design:
//   * the pixels in stages of JC = 32: with j = jl + JC s, e^{-i m phi_j} =
//     e^{-i pi m (2 jl + h) / N} e^{-i pi m 2 JC s / N}, so a block's (pixel
//     x m) table is one JC x COLS tile, made once (one cospi a (u, group)
//     into the half-wave table, the tile's entries gathered from it), and
//     each stage's sums (P, Q) are turned by the stage's angle on the CUDA
//     cores.  Complex64 sums each stage from zero and adds the turned stage
//     sum to the running total (the turn of (m, s) read from the half-wave
//     table, so no angle error compounds); complex128 walks the stages from
//     the last and turns the running total by the one step e^{-i pi m 2 JC
//     / N} before each (Horner; its float64 error grows by ~1e-16 a stage);
//   * complex64 on the tensor cores' full rate: warpgroup products (wgmma
//     m64nNk8 tf32, N = 2 COLS up to 128; tma_ring.cuh), 3xTF32 (each
//     operand split into tf32 big + small: small.big + big.small +
//     big.big), A -- a warp's 8 rows x {re, im} -- split in registers from
//     the staged maps, B -- the table tile, cos and sin interleaved along N
//     -- stored once a block as big and small K-major planes in the
//     128-byte swizzle.  A stage's twelve products start from a zero
//     accumulator, its eight small products first (the tensor cores add
//     with truncation: the big sum meets four adds), and the turned stage
//     sum joins the float32 running total on the CUDA cores, which keeps
//     the result no farther from the complex128 truth than the FFT
//     route's;
//   * complex128 on the float64 mma.sync m16n8k4 (IEEE products and sums;
//     wgmma has no float64), a warp 16 rows x 4 NT m;
//   * a ring of NSTAGE (plan: 2-4) shared-memory stages of the maps filled
//     by 16-byte cp.async, NSTAGE - 1 stages ahead of the products, one
//     barrier a stage; the staged rows and the float64 table rows are
//     padded (4 pixels; 4 entries), so that neither the copies nor the
//     fragment loads meet a bank conflict;
//   * a thread's accumulators hold (P re, Q re, P im, Q im) of one (row, m)
//     (the wgmma and mma.sync fragments agree), so the turns, F and G are
//     formed in registers;
//   * the tile from a per-call plan (ops/sht.py phase_plan): rows a block
//     32 or 64 in complex64 (one or two warpgroups), 16, 32 or 64 in
//     complex128 (the caps' 2B-row groups fill them), m a tile 8 NT (NT =
//     1..8: up to 64 m in one tile, nm above that split evenly into
//     multiples of 8, so ns1b's 33 m take 40 columns and the maps are read
//     once).  The m tiles of a row tile are neighbours in the grid, so the
//     maps come from device memory about once.
// The inverse walks m in stages of MC (32 complex64, 16 complex128) and
// gathers each stage's (m x pixel) table tile from the half-wave table
// (kept as table entries, split into tf32 big + small once) into a second
// double-buffered tile, once for every row of the block (turning the stage
// sums instead, as the forward does, would need the imaginary part of the
// real form's stage sums: twice its products); its products run on 3xTF32
// mma.sync m16n8k8 (complex64: each 8-deep step from zero, added to the
// stage sum on the CUDA cores) or the float64 mma.sync; it tiles 32 WR
// (real) or 16 WR (complex) rows x 32 or 64 pixels.
// Each output is summed over j (over m in the inverse) in the same order
// whatever tile or column computes it (the stages depend on N and the type
// alone, not on the plan; a tensor-core element's result depends only on
// its row, its column and its sum; each table entry and turn on (t, N)
// alone), so a window's columns equal the full range's bit for bit; no
// atomics and no split over the pixels (or over m in the inverse), so two
// launches give the same bits.  One launch a call.
//
// ptxas -v (sm_90a; experiments/k4_turns.py prints its lines), registers
// a thread, no spills in any instantiation:
//   phase_fwd_tf32<NQ>, NQ = 1..8:  72  98 125 120 154 154 168 202
//   phase_fwd_f64<NT>,  NT = 1..8:  96 128 120 116 140 166 188 212
//   phase_inv_kernel<float>  real 167 (32 pixels) 249 (64), complex 159 245
//   phase_inv_kernel<double> real  96 (32 pixels) 128 (64), complex 110 126
//
// Plain versions: driftscan_tpu_torch.ops.sht.phase_stage_ref and
// phase_stage_inv_ref (one FFT a ring length, the JAX package's bins).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "tma_ring.cuh"

namespace {

constexpr int GF = 5;        // a group row: N, h, rings, first ring, ring stride
constexpr int MT = 2;        // mma row tiles a warp (mma.sync kernels)
constexpr int WC = 2;        // warps along the columns (m forward, pixels inverse)
constexpr int MAX_THREADS = 256;
constexpr size_t MAX_SMEM = 232448;
constexpr int JC = 32;       // pixels a forward stage, both types

// per type: the depth of one mma.sync (pixels forward; 4 m x {cos, sin} or
// 2 m x {cos, sin} inverse) and the m of an inverse stage (MC).  The stages
// fix the order of every sum: they do not depend on the plan.
template <typename T> struct Prec;
template <> struct Prec<float> {
  static constexpr int KS = 8, MC = 32;
  using C2 = float2;
  using E = uint2;  // a table value as tf32 (big, small)
};
template <> struct Prec<double> {
  static constexpr int KS = 4, MC = 16;
  using C2 = double2;
  using E = double;
};

__device__ __forceinline__ uint2 entry_of(float, double v) {
  uint32_t big, small;
  mma::tf32_split((float)v, big, small);
  return make_uint2(big, small);
}
__device__ __forceinline__ double entry_of(double, double v) { return v; }

// IEEE operations the compiler may not contract or reorder: the turns give
// the same bits in every instantiation
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// (a + b) mod n for a, b < n <= 2^31
__device__ __forceinline__ unsigned add_mod(unsigned a, unsigned b, unsigned n) {
  const unsigned s = a + b;
  return s >= n ? s - n : s;
}

// The ring's angle table: cos(pi t / N) and sin(pi t / N), 0 <= t < 2N, from
// the half-wave table hw[a] = cos(pi a / N), a = 0 .. N.
struct Angles {
  unsigned N, n2, half, q3;
  __device__ Angles(int n) : N(n), n2(2u * n), half(n / 2), q3(3u * (n / 2)) {}
  __device__ __forceinline__ unsigned fold(unsigned t) const { return t <= N ? t : n2 - t; }
  __device__ __forceinline__ unsigned cos_at(unsigned t) const { return fold(t); }
  __device__ __forceinline__ unsigned sin_at(unsigned t) const {
    return fold(t >= half ? t - half : t + q3);
  }
  // m k mod 2N, exactly, for k <= 2 JC + 1 (2N k < 2^32 up to nside 2^20)
  __device__ __forceinline__ unsigned angle(unsigned m, unsigned k) const {
    return (m % n2) * k % n2;
  }
};

// the half-wave table of a group of N-pixel rings as table entries, one
// cospi an entry
template <typename T>
__device__ __forceinline__ void fill_half_wave(typename Prec<T>::E* hw, int N) {
  for (int u = threadIdx.x; u <= N; u += blockDim.x)
    hw[u] = entry_of(T(0), cospi((double)u / (double)N));
}

// row q of a group: unit q / rings on the group's (q % rings)-th ring
struct Row {
  int b, ring;
};
__device__ __forceinline__ Row group_row(int q, int nr, int first, int stride) {
  const int b = q / nr;
  return {b, first + (q - b * nr) * stride};
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// dynamic shared memory of a launch (ops/sht.py phase_plan repeats it).
// complex64 forward: 1024 bytes of alignment slack, the table's big and
// small planes (2 cols rows of 128 bytes each), the turns of two stages,
// the half-wave table, the ring's stages, the rows' map offsets
constexpr size_t fwd32_smem(int rows, int cols, int maxlen, int nstage) {
  return 1024 + 2 * (size_t)(2 * cols) * 128 + 16 * (size_t)cols +
         align16((size_t)(maxlen + 1) * 4) + (size_t)nstage * rows * (JC + 4) * 8 +
         8 * (size_t)rows;
}
// complex128 forward: the half-wave table, the ring's stages, the table
// tile (padded rows), the one-step turns, the rows' map offsets
constexpr size_t fwd64_smem(int rows, int cols, int maxlen, int nstage) {
  return align16((size_t)(maxlen + 1) * 8) + (size_t)nstage * rows * (JC + 4) * 16 +
         (size_t)JC * (2 * cols + 4) * 8 + 16 * (size_t)cols + 8 * (size_t)rows;
}
// inverse: the half-wave table as entries, the ring's stages, two table
// tiles
template <typename T>
constexpr size_t inv_smem(int rows, int pix, int maxlen, int nstage, bool real) {
  return align16((size_t)(maxlen + 1) * 8) +
         (size_t)nstage * (real ? 1 : 2) * rows * (Prec<T>::MC + 4) *
             sizeof(typename Prec<T>::C2) +
         2 * (size_t)Prec<T>::MC * (pix + (sizeof(T) == 4 ? 2 : 4)) * 16;
}

__device__ __forceinline__ void wait_ring(int nstage) {
  // at most nstage - 2 groups in flight: the stage about to be read landed
  if (nstage >= 4) mma::cp_async_wait<2>();
  else if (nstage == 3) mma::cp_async_wait<1>();
  else mma::cp_async_wait<0>();
}

// (P, Q) turned by the angle (c, s): (c P - s Q, s P + c Q)
template <typename T>
__device__ __forceinline__ void turn(T& p, T& q, T c, T s) {
  const T p2 = fma_rn(c, p, mul_rn(-s, q));
  q = fma_rn(s, p, mul_rn(c, q));
  p = p2;
}

// ------------------------------------------------------------- forward
//
// Both forward kernels: the block's rows (unit, ring) of one group (a row
// tile of ops/sht.py phase_tiles) and COLS m (one m tile), the pixels in
// stages of JC through a ring of NSTAGE shared-memory stages.  The maps of
// row r sit at rowoff[r] (-1 past the group's rows); a stage is rows x JC
// complex pixels, 16-byte copies, pixels past N filled with zeros.
template <typename C2>
struct Staging {
  static constexpr int XP = JC + 4;                 // padded staged row, complex pixels
  static constexpr int PPC = 16 / (int)sizeof(C2);  // pixels a 16-byte copy
  static constexpr int CPR = JC / PPC;              // copies a staged row
  const C2* maps;
  const long long* rowoff;
  C2* xs;
  int rows, nstage, nst, N;
  bool reverse;  // ring slot k holds stage nst - 1 - k

  // rowoff for the block's rows (one thread a row)
  __device__ static void offsets(long long* rowoff, int rows, int row0, int nrows, int nr,
                                 int first, int stride, int nring, int maxlen) {
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const int q = row0 + r;
      long long o = -1;
      if (q < nrows) {
        const Row w = group_row(q, nr, first, stride);
        o = ((long long)w.b * nring + w.ring) * maxlen;
      }
      rowoff[r] = o;
    }
  }
  // issue stage k's copies (a committed group, empty past the last stage)
  __device__ __forceinline__ void copy(int k) const {
    if (k < nst) {
      C2* dst = xs + (size_t)(k % nstage) * rows * XP;
      const int j0 = (reverse ? nst - 1 - k : k) * JC;
      for (int e = threadIdx.x; e < rows * CPR; e += blockDim.x) {
        const int r = e / CPR, j = (e % CPR) * PPC;
        const long long o = rowoff[r];
        const bool ok = o >= 0 && j0 + j < N;
        mma::cp_async<16>(dst + r * XP + j, ok ? maps + o + j0 + j : maps, ok);
      }
    }
    mma::cp_async_commit();
  }
  __device__ __forceinline__ const C2* stage(int k) const {
    return xs + (size_t)(k % nstage) * rows * XP;
  }
};

// Complex64: a block of 128 WG threads owns 32 WG rows (warpgroup wg rows
// 32 wg .. 32 wg + 31, warp w of it 8 rows: its m16n8k8 fragment's rows g
// and g + 8 are row 8 w + g's re and im) x COLS = 8 NQ m, the product's N =
// 2 COLS columns (m, cos) and (m, sin) interleaved.
template <int NQ>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    phase_fwd_tf32(const float2* __restrict__ maps, const int* __restrict__ groups,
                   const int2* __restrict__ tiles, float2* __restrict__ F,
                   float2* __restrict__ G, int B, int nring, int maxlen, int m0, int nm, int nmt,
                   int rows, int nstage) {
  constexpr int COLS = 8 * NQ, N = 2 * COLS;  // m a tile; the product's columns
  constexpr int PLANE = N * 128;              // a K-major plane: N rows of JC tf32
  using St = Staging<float2>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int nthr = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, w = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;

  const int2 tile = tiles[blockIdx.x / nmt];
  const int col0 = (blockIdx.x % nmt) * COLS;
  const int* gr = groups + GF * tile.x;
  const int Nr = gr[0], h = gr[1], nr = gr[2], first = gr[3], stride = gr[4];
  const int nrows = B * nr, row0 = tile.y;
  const int nst = (Nr + JC - 1) / JC;

  unsigned char* big = smem;
  unsigned char* small = smem + PLANE;
  float* tw = reinterpret_cast<float*>(smem + 2 * PLANE);  // [2][COLS][cos, sin]
  float* hw = tw + 4 * COLS;
  float2* xs = reinterpret_cast<float2*>(reinterpret_cast<unsigned char*>(hw) +
                                         align16((size_t)(maxlen + 1) * 4));
  long long* rowoff = reinterpret_cast<long long*>(xs + (size_t)nstage * rows * St::XP);

  St::offsets(rowoff, rows, row0, nrows, nr, first, stride, nring, maxlen);
  __syncthreads();
  const St ring{maps, rowoff, xs, rows, nstage, nst, Nr, false};
  // the first NSTAGE - 1 stages go out before the tables are made
  for (int k = 0; k < nstage - 1; ++k) ring.copy(k);

  for (int u = tid; u <= Nr; u += nthr) hw[u] = (float)cospi((double)u / (double)Nr);
  const Angles ang(Nr);
  __syncthreads();  // the half-wave table is whole

  // the table tile: column 2c (2c + 1) of pixel jl is cos (sin) (pi m (2 jl
  // + h) / N), m = m0 + col0 + c, split into the big and small planes
  for (int e = tid; e < COLS * JC; e += nthr) {
    const int c = e / JC, jl = e % JC;
    const unsigned a = ang.angle((unsigned)(m0 + col0 + c), 2u * jl + h);
    const float v[2] = {hw[ang.cos_at(a)], hw[ang.sin_at(a)]};
#pragma unroll
    for (int cs = 0; cs < 2; ++cs) {
      uint32_t vb, vs;
      mma::tf32_split(v[cs], vb, vs);
      const uint32_t o = ring::sw128((uint32_t)(2 * c + cs) * 128 + jl * 4);
      *reinterpret_cast<uint32_t*>(big + o) = vb;
      *reinterpret_cast<uint32_t*>(small + o) = vs;
    }
  }
  // the turn of column tid: its step dt = m 2 JC mod 2N and the running
  // angle tc = s dt of the stage it writes next; stage 0's is (1, 0)
  unsigned dt = 0, tc = 0;
  if (tid < COLS) {
    dt = ang.angle((unsigned)(m0 + col0 + tid), 2u * JC);
    tw[2 * tid] = hw[ang.cos_at(0)];
    tw[2 * tid + 1] = hw[ang.sin_at(0)];
  }
  ring::fence_async_smem();  // the planes, written here, are read by wgmma

  const bool active = row0 + 32 * wg < nrows;
  const uint64_t dbig = ring::desc_sw128(big, 0, 1024);
  const uint64_t dsmall = ring::desc_sw128(small, 0, 1024);

  // acc[4q + r]: the stage's (P re, Q re, P im, Q im) of row 32 wg + 8 w + g,
  // m col0 + 4q + t (the wgmma fragment: rows g, g + 8; columns 2t, 2t + 1
  // of each 8); sum the running total
  float acc[N / 2], sum[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) acc[j] = sum[j] = 0.f;

  for (int s = 0; s < nst; ++s) {
    wait_ring(nstage);
    __syncthreads();  // stage s landed; every warp past stage s - 1
    ring.copy(s + nstage - 1);
    // the turns of stage s + 1 into the slot stage s - 1 read
    if (tid < COLS && s + 1 < nst) {
      tc = add_mod(tc, dt, ang.n2);
      float* p = tw + ((s + 1) & 1) * 2 * COLS + 2 * tid;
      p[0] = hw[ang.cos_at(tc)];
      p[1] = hw[ang.sin_at(tc)];
    }
    if (!active) continue;
    // A: the warp's 16 rows (8 rows' re and im) at pixels kk + t and kk + t
    // + 4 of each 8-deep step, split into tf32 big and small
    const float2* xt = ring.stage(s) + (32 * wg + 8 * w + g) * St::XP + t;
    uint32_t ab[JC / 8][4], as[JC / 8][4];
#pragma unroll
    for (int k = 0; k < JC / 8; ++k) {
      const float2 v0 = xt[8 * k], v1 = xt[8 * k + 4];
      mma::tf32_split(v0.x, ab[k][0], as[k][0]);
      mma::tf32_split(v0.y, ab[k][1], as[k][1]);
      mma::tf32_split(v1.x, ab[k][2], as[k][2]);
      mma::tf32_split(v1.y, ab[k][3], as[k][3]);
    }
    // the stage's twelve products from a zero accumulator: the eight small
    // ones first, so that the truncating adds meet the big sum only in the
    // last four; nothing touches acc while they are in flight
    ring::fence_operand(acc);
    ring::wg_fence();
#pragma unroll
    for (int k = 0; k < JC / 8; ++k) {
      ring::wgmma_tf32<N>(acc, as[k], dbig + 2 * k, k > 0);
      ring::wgmma_tf32<N>(acc, ab[k], dsmall + 2 * k, 1);
    }
#pragma unroll
    for (int k = 0; k < JC / 8; ++k) ring::wgmma_tf32<N>(acc, ab[k], dbig + 2 * k, 1);
    ring::wg_commit();
    ring::wg_wait<0>();
    ring::fence_operand(acc);
    const float* tws = tw + (s & 1) * 2 * COLS;
#pragma unroll
    for (int q = 0; q < N / 8; ++q) {
      const float zc = tws[2 * (4 * q + t)], zs = tws[2 * (4 * q + t) + 1];
      turn(acc[4 * q], acc[4 * q + 1], zc, zs);
      turn(acc[4 * q + 2], acc[4 * q + 3], zc, zs);
#pragma unroll
      for (int r = 0; r < 4; ++r) sum[4 * q + r] = add_rn(sum[4 * q + r], acc[4 * q + r]);
    }
  }
  mma::cp_async_wait<0>();
  const int qrow = row0 + 32 * wg + 8 * w + g;
  if (!active || qrow >= nrows) return;
  const Row rw = group_row(qrow, nr, first, stride);
#pragma unroll
  for (int q = 0; q < N / 8; ++q) {
    const int col = col0 + 4 * q + t;
    if (col >= nm) continue;
    const size_t o = ((size_t)rw.b * nm + col) * nring + rw.ring;
    const float pr = sum[4 * q], qr = sum[4 * q + 1], pi = sum[4 * q + 2], qi = sum[4 * q + 3];
    F[o] = make_float2(pr + qi, pi - qr);
    G[o] = make_float2(pr - qi, pi + qr);
  }
}

// Complex128: a block owns R = 16 WR rows x COLS = 8 NT m: WR x 2 warps, a
// warp MT = 2 row tiles (8 rows, re and im) x NT column tiles (4 m, cos and
// sin) of mma.sync m16n8k4.  It walks the stages from the last (Horner).
template <int NT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    phase_fwd_f64(const double2* __restrict__ maps, const int* __restrict__ groups,
                  const int2* __restrict__ tiles, double2* __restrict__ F,
                  double2* __restrict__ G, int B, int nring, int maxlen, int m0, int nm, int nmt,
                  int rows, int nstage) {
  constexpr int KS = 4;                       // pixels an mma
  constexpr int COLS = WC * 4 * NT;           // m a tile
  constexpr int TQ = 2 * COLS + 4;            // padded table row, entries
  using St = Staging<double2>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int nthr = blockDim.x;  // 4 rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;

  const int2 tile = tiles[blockIdx.x / nmt];
  const int col0 = (blockIdx.x % nmt) * COLS;
  const int* gr = groups + GF * tile.x;
  const int N = gr[0], h = gr[1], nr = gr[2], first = gr[3], stride = gr[4];
  const int nrows = B * nr, row0 = tile.y;
  const int nst = (N + JC - 1) / JC;

  double* hw = reinterpret_cast<double*>(smem);
  double2* xs = reinterpret_cast<double2*>(smem + align16((size_t)(maxlen + 1) * 8));
  double* tb = reinterpret_cast<double*>(xs + (size_t)nstage * rows * St::XP);
  double* tw = tb + JC * TQ;  // [COLS][cos, sin] of the one step
  long long* rowoff = reinterpret_cast<long long*>(tw + 2 * COLS);

  St::offsets(rowoff, rows, row0, nrows, nr, first, stride, nring, maxlen);
  __syncthreads();
  const St ring{maps, rowoff, xs, rows, nstage, nst, N, true};
  for (int k = 0; k < nstage - 1; ++k) ring.copy(k);

  for (int u = tid; u <= N; u += nthr) hw[u] = cospi((double)u / (double)N);
  const Angles ang(N);
  __syncthreads();  // the half-wave table is whole

  // the table tile: (jl, 2c) and (jl, 2c + 1) hold cos, sin (pi m (2 jl +
  // h) / N), m = m0 + col0 + c
  for (int e = tid; e < JC * COLS; e += nthr) {
    const int jl = e / COLS, c = e % COLS;
    const unsigned a = ang.angle((unsigned)(m0 + col0 + c), 2u * jl + h);
    *reinterpret_cast<double2*>(tb + jl * TQ + 2 * c) =
        make_double2(hw[ang.cos_at(a)], hw[ang.sin_at(a)]);
  }
  // the one step of column tid: pi m 2 JC / N
  if (tid < COLS) {
    const unsigned a = ang.angle((unsigned)(m0 + col0 + tid), 2u * JC);
    tw[2 * tid] = hw[ang.cos_at(a)];
    tw[2 * tid + 1] = hw[ang.sin_at(a)];
  }

  const int wrow = wr * 8 * MT;        // the warp's first row in the tile
  const int wcol = wc * 8 * NT;        // its first real column (2 a m)
  const bool active = row0 + wrow < nrows && col0 + wc * 4 * NT < nm;

  // (P re, Q re, P im, Q im) of (row wrow + 8a + g, m col0 + wcol / 2 + 4c
  // + t): the running total
  double sum[MT][NT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) sum[a][c][r] = 0.0;

  const double* tt = tb + t * TQ + wcol + g;
  for (int s = 0; s < nst; ++s) {
    wait_ring(nstage);
    __syncthreads();  // stage s landed; every warp past stage s - 1
    ring.copy(s + nstage - 1);
    if (!active) continue;
    if (s > 0) {
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        const int mc = wc * 4 * NT + 4 * c + t;
        const double zc = tw[2 * mc], zs = tw[2 * mc + 1];
#pragma unroll
        for (int a = 0; a < MT; ++a) {
          turn(sum[a][c][0], sum[a][c][1], zc, zs);
          turn(sum[a][c][2], sum[a][c][3], zc, zs);
        }
      }
    }
    const double2* xt = ring.stage(s) + (wrow + g) * St::XP + t;
#pragma unroll
    for (int kk = 0; kk < JC; kk += KS) {
      double2 av[MT];
#pragma unroll
      for (int a = 0; a < MT; ++a) av[a] = xt[a * 8 * St::XP + kk];
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        const double b = tt[kk * TQ + 8 * c];
#pragma unroll
        for (int a = 0; a < MT; ++a) mma::dmma_16x8x4(sum[a][c], av[a].x, av[a].y, b);
      }
    }
  }
  mma::cp_async_wait<0>();
  if (!active) return;
#pragma unroll
  for (int a = 0; a < MT; ++a) {
    const int q = row0 + wrow + 8 * a + g;
    if (q >= nrows) continue;
    const Row w = group_row(q, nr, first, stride);
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      const int col = col0 + wcol / 2 + 4 * c + t;
      if (col >= nm) continue;
      const size_t o = ((size_t)w.b * nm + col) * nring + w.ring;
      const double pr = sum[a][c][0], qr = sum[a][c][1], pi = sum[a][c][2],
                   qi = sum[a][c][3];
      F[o] = make_double2(pr + qi, pi - qr);
      G[o] = make_double2(pr - qi, pi + qr);
    }
  }
}

// ------------------------------------------------------------- inverse
//
// A block owns R rows of one group (16 a row tile of the real form, 8 of
// the complex, where the tile's rows g and g + 8 are a row's re and im) x
// PIX = 16 NT pixels: WR x 2 warps, a warp MT = 2 row tiles x NT column
// tiles (8 pixels).  It walks m in stages of MC.
template <typename T, bool REAL, int NT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    phase_inv_kernel(const typename Prec<T>::C2* __restrict__ tpos,
                     const typename Prec<T>::C2* __restrict__ tneg, const int* __restrict__ groups,
                     const int2* __restrict__ tiles, T* __restrict__ out, int B, int nring,
                     int maxlen, int nm, int njt, int rows, int nstage) {
  using C2 = typename Prec<T>::C2;
  using E = typename Prec<T>::E;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int KS = Prec<T>::KS, MC = Prec<T>::MC;
  constexpr int KM = KS / 2;                  // m an mma step
  constexpr int RPT = REAL ? 16 : 8;          // rows a row tile
  constexpr int NA = REAL ? 1 : 2;            // coefficient arrays
  constexpr int MP = MC + 4;                  // padded staged row, coefficients
  constexpr int PIX = WC * NT * 8;            // pixels a tile
  constexpr int PP = PIX + (F32 ? 2 : 4);     // padded table row, (cos, sin) pairs
  constexpr int CPT = RPT * MT * MC * NA / 64;  // copies a thread: R MC NA / (64 WR)
  constexpr int OW = REAL ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem[];

  const int nthr = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;

  const int2 tile = tiles[blockIdx.x / njt];
  const int j0 = (blockIdx.x % njt) * PIX;
  const int* gr = groups + GF * tile.x;
  const int N = gr[0], h = gr[1], nr = gr[2], first = gr[3], stride = gr[4];
  const int nrows = B * nr, row0 = tile.y;

  if (j0 >= N) {  // padding slots only
    for (int e = tid; e < rows * PIX; e += nthr) {
      const int q = row0 + e / PIX, j = j0 + e % PIX;
      if (q >= nrows || j >= maxlen) continue;
      const Row w = group_row(q, nr, first, stride);
      T* o = out + (((size_t)w.b * nring + w.ring) * maxlen + j) * OW;
      o[0] = T(0);
      if constexpr (!REAL) o[1] = T(0);
    }
    return;
  }
  const int nst = (nm + MC - 1) / MC;

  E* hw = reinterpret_cast<E*>(smem);
  C2* co = reinterpret_cast<C2*>(smem + align16((size_t)(maxlen + 1) * 8));
  const int cstage = NA * rows * MP;
  E* tb = reinterpret_cast<E*>(co + (size_t)nstage * cstage);  // pairs: 2 entries each

  // the coefficient copies of this thread: row tid % R (the thread count is
  // a multiple of R), m and array stepping with k
  const int crow = tid % rows;
  long long coff = -1;
  if (row0 + crow < nrows) {
    const Row w = group_row(row0 + crow, nr, first, stride);
    coff = (long long)w.b * nm * nring + w.ring;
  }
  auto stage_copy = [&](int s) {
    if (s < nst) {
      C2* dst = co + (size_t)(s % nstage) * cstage + crow * MP;
      const int mc0 = s * MC;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int e = (tid + nthr * k) / rows;  // array x MC + m
        const int arr = e / MC, mi = e % MC;
        const bool ok = coff >= 0 && mc0 + mi < nm;
        const C2* src = (arr == 0 || REAL) ? tpos : tneg;
        mma::cp_async<(int)sizeof(C2)>(dst + arr * rows * MP + mi,
                                  ok ? src + coff + (long long)(mc0 + mi) * nring : tpos, ok);
      }
    }
    mma::cp_async_commit();
  };
  for (int s = 0; s < nstage - 1; ++s) stage_copy(s);

  fill_half_wave<T>(hw, N);
  const Angles ang(N);

  // the table entries this thread gathers: pixel jl, m mfirst + mstep k of
  // each stage; t = m (2 j + h) mod 2N stepped exactly
  const int jl = tid % PIX, mfirst = tid / PIX, mstep = nthr / PIX;
  const unsigned n2 = ang.n2;
  const unsigned kj = (unsigned)((2ll * (j0 + jl) + h) % n2);
  unsigned tstart = (unsigned)(((unsigned long long)mfirst * kj) % n2);
  const unsigned tstep = (unsigned)(((unsigned long long)mstep * kj) % n2);
  const unsigned dstart = (unsigned)(((unsigned long long)MC * kj) % n2);
  __syncthreads();  // the half-wave table is whole

  auto build = [&](int buf) {
    E* col = tb + ((size_t)buf * MC * PP + jl) * 2;
    unsigned tc = tstart;
    for (int mi = mfirst; mi < MC; mi += mstep) {
      const E cv = hw[ang.cos_at(tc)], sv = hw[ang.sin_at(tc)];
      if constexpr (F32)
        *reinterpret_cast<uint4*>(col + 2 * mi * PP) = make_uint4(cv.x, cv.y, sv.x, sv.y);
      else
        *reinterpret_cast<double2*>(col + 2 * mi * PP) = make_double2(cv, sv);
      tc = add_mod(tc, tstep, n2);
    }
    tstart = add_mod(tstart, dstart, n2);
  };
  build(0);

  const int wrow = wr * RPT * MT;   // the warp's first row in the tile (REAL) / first unit row
  const int wpix = wc * 8 * NT;     // its first pixel in the tile
  const bool active = row0 + (REAL ? wrow : wr * 8 * MT) < nrows && j0 + wpix < N;

  // the (row, pixel) pairs of c0..c3: the running total, st the stage's
  T sum[MT][NT][4], st[MT][NT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) sum[a][c][r] = st[a][c][r] = T(0);

  // staged coefficient row of the thread's row tile a (and of row g + 8)
  const int arow = REAL ? wrow + g : wr * 8 * MT + g;
  for (int s = 0; s < nst; ++s) {
    wait_ring(nstage);
    __syncthreads();
    stage_copy(s + nstage - 1);
    if (s + 1 < nst) build((s + 1) & 1);
    if (!active) continue;
    const C2* ct = co + (size_t)(s % nstage) * cstage + arow * MP;
    const E* tt = tb + (size_t)(s & 1) * MC * PP * 2;
    const int mc0 = s * MC;
#pragma unroll
    for (int mi = 0; mi < MC; mi += KM) {
      if constexpr (F32) {
        // k = cs 4 + m: a0 (row g, cos), a1 (row g + 8, cos), a2 (row g,
        // sin), a3 (row g + 8, sin) of m = mi + t
        const int m = mi + t;
        uint32_t ab[MT][4], as[MT][4];
#pragma unroll
        for (int a = 0; a < MT; ++a) {
          float v[4];
          if constexpr (REAL) {
            const float w = mc0 + m == 0 ? 1.f : 2.f;  // exact: the split scales with it
            const float2 p0 = ct[(16 * a) * MP + m], p1 = ct[(16 * a + 8) * MP + m];
            v[0] = w * p0.x;
            v[1] = w * p1.x;
            v[2] = -w * p0.y;
            v[3] = -w * p1.y;
          } else {
            const float2 p = ct[(8 * a) * MP + m], n = ct[rows * MP + (8 * a) * MP + m];
            v[0] = p.x + n.x;  // A re: re row, cos
            v[1] = p.y + n.y;  // A im: im row, cos
            v[2] = n.y - p.y;  // -D im: re row, sin
            v[3] = p.x - n.x;  // D re: im row, sin
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) mma::tf32_split(v[r], ab[a][r], as[a][r]);
        }
#pragma unroll
        for (int c = 0; c < NT; ++c) {
          const uint4 b = *reinterpret_cast<const uint4*>(tt + ((mi + t) * PP + wpix + 8 * c + g) * 2);
#pragma unroll
          for (int a = 0; a < MT; ++a) {
            float d[4];
            mma::mma_tf32_16x8x8_zero(d, as[a], b.x, b.z);
            mma::mma_tf32_16x8x8(d, ab[a], b.y, b.w);
            mma::mma_tf32_16x8x8(d, ab[a], b.x, b.z);
#pragma unroll
            for (int r = 0; r < 4; ++r) st[a][c][r] += d[r];
          }
        }
      } else {
        // k = cs 2 + m: a0 (row g), a1 (row g + 8) of m = mi + (t & 1),
        // cos for t < 2, sin after
        const int m = mi + (t & 1);
        const bool sn = t >= 2;
        double a0[MT], a1[MT];
#pragma unroll
        for (int a = 0; a < MT; ++a) {
          if constexpr (REAL) {
            const double w = mc0 + m == 0 ? 1.0 : 2.0;
            const double2 p0 = ct[(16 * a) * MP + m], p1 = ct[(16 * a + 8) * MP + m];
            a0[a] = sn ? -w * p0.y : w * p0.x;
            a1[a] = sn ? -w * p1.y : w * p1.x;
          } else {
            const double2 p = ct[(8 * a) * MP + m], n = ct[rows * MP + (8 * a) * MP + m];
            a0[a] = sn ? n.y - p.y : p.x + n.x;
            a1[a] = sn ? p.x - n.x : p.y + n.y;
          }
        }
#pragma unroll
        for (int c = 0; c < NT; ++c) {
          const double b = tt[(m * PP + wpix + 8 * c + g) * 2 + (sn ? 1 : 0)];
#pragma unroll
          for (int a = 0; a < MT; ++a) mma::dmma_16x8x4(sum[a][c], a0[a], a1[a], b);
        }
      }
    }
    if constexpr (F32) {
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int c = 0; c < NT; ++c)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            sum[a][c][r] += st[a][c][r];
            st[a][c][r] = T(0);
          }
    }
  }
  mma::cp_async_wait<0>();

  // every valid (row, pixel) of the warp is written, the ring's padding
  // slots as zeros (a thread's pixel pair lies inside or past N, a
  // multiple of 4)
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    const int j = j0 + wpix + 8 * c + 2 * t;
    if (j >= maxlen) continue;
    const bool inside = j < N;
#pragma unroll
    for (int a = 0; a < MT; ++a) {
      if constexpr (REAL) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int q = row0 + wrow + 16 * a + 8 * hh + g;
          if (q >= nrows) continue;
          const Row w = group_row(q, nr, first, stride);
          T* o = out + ((size_t)w.b * nring + w.ring) * maxlen + j;
          C2 v;
          v.x = inside ? sum[a][c][2 * hh] : T(0);
          v.y = inside ? sum[a][c][2 * hh + 1] : T(0);
          *reinterpret_cast<C2*>(o) = v;
        }
      } else {
        const int q = row0 + wr * 8 * MT + 8 * a + g;
        if (q >= nrows) continue;
        const Row w = group_row(q, nr, first, stride);
        C2* o = reinterpret_cast<C2*>(out) + ((size_t)w.b * nring + w.ring) * maxlen + j;
        C2 v0, v1;
        v0.x = inside ? sum[a][c][0] : T(0);
        v0.y = inside ? sum[a][c][2] : T(0);
        v1.x = inside ? sum[a][c][1] : T(0);
        v1.y = inside ? sum[a][c][3] : T(0);
        o[0] = v0;
        o[1] = v1;
      }
    }
  }
}

// ------------------------------------------------------------- launches

template <int NQ>
int launch_fwd32_nq(const void* maps, const int* groups, const int* tiles, int ntiles, void* F,
                    void* G, int B, int nring, int maxlen, int m0, int nm, int rows, int nstage,
                    cudaStream_t stream) {
  constexpr auto kernel = phase_fwd_tf32<NQ>;
  const size_t smem = fwd32_smem(rows, 8 * NQ, maxlen, nstage);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int nmt = (nm + 8 * NQ - 1) / (8 * NQ);
  if ((long long)ntiles * nmt > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = ring::allow_smem<kernel>(smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<ntiles * nmt, 4 * rows, smem, stream>>>(
      static_cast<const float2*>(maps), groups, reinterpret_cast<const int2*>(tiles),
      static_cast<float2*>(F), static_cast<float2*>(G), B, nring, maxlen, m0, nm, nmt, rows,
      nstage);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_fwd64_nt(const void* maps, const int* groups, const int* tiles, int ntiles, void* F,
                    void* G, int B, int nring, int maxlen, int m0, int nm, int rows, int nstage,
                    cudaStream_t stream) {
  constexpr auto kernel = phase_fwd_f64<NT>;
  constexpr int COLS = WC * 4 * NT;
  const size_t smem = fwd64_smem(rows, COLS, maxlen, nstage);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int nmt = (nm + COLS - 1) / COLS;
  if ((long long)ntiles * nmt > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = ring::allow_smem<kernel>(smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<ntiles * nmt, 4 * rows, smem, stream>>>(
      static_cast<const double2*>(maps), groups, reinterpret_cast<const int2*>(tiles),
      static_cast<double2*>(F), static_cast<double2*>(G), B, nring, maxlen, m0, nm, nmt, rows,
      nstage);
  return (int)cudaGetLastError();
}

// rows a tile: 32 or 64 (complex64: one or two warpgroups), 16, 32 or 64
// (complex128)
template <bool F32>
int launch_fwd(const void* maps, const int* groups, const int* tiles, int ntiles, void* F,
               void* G, int B, int nring, int maxlen, int m0, int nm, int rows, int cols,
               int nstage, cudaStream_t stream) {
  const bool rows_ok = F32 ? (rows == 32 || rows == 64) : (rows == 16 || rows == 32 || rows == 64);
  if (B < 0 || nm < 0 || m0 < 0 || ntiles < 0 || !rows_ok || cols % 8 != 0 || cols < 8 ||
      cols > 64 || nstage < 2 || nstage > 4)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || nm == 0 || ntiles == 0) return 0;
#define K4_FWD(K)                                                                           \
  case K:                                                                                   \
    return F32 ? launch_fwd32_nq<K>(maps, groups, tiles, ntiles, F, G, B, nring, maxlen, m0, \
                                    nm, rows, nstage, stream)                               \
               : launch_fwd64_nt<K>(maps, groups, tiles, ntiles, F, G, B, nring, maxlen, m0, \
                                    nm, rows, nstage, stream);
  switch (cols / 8) {
    K4_FWD(1) K4_FWD(2) K4_FWD(3) K4_FWD(4) K4_FWD(5) K4_FWD(6) K4_FWD(7) K4_FWD(8)
  }
#undef K4_FWD
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool REAL, int NT>
int launch_inv_nt(const void* tpos, const void* tneg, const int* groups, const int* tiles,
                  int ntiles, void* out, int B, int nring, int maxlen, int nm, int rows,
                  int nstage, cudaStream_t stream) {
  using C2 = typename Prec<T>::C2;
  constexpr auto kernel = phase_inv_kernel<T, REAL, NT>;
  constexpr int PIX = WC * NT * 8;
  const size_t smem = inv_smem<T>(rows, PIX, maxlen, nstage, REAL);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int njt = (maxlen + PIX - 1) / PIX;
  if ((long long)ntiles * njt > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = ring::allow_smem<kernel>(smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<ntiles * njt, (REAL ? 2 : 4) * rows, smem, stream>>>(
      static_cast<const C2*>(tpos), static_cast<const C2*>(tneg), groups,
      reinterpret_cast<const int2*>(tiles), static_cast<T*>(out), B, nring, maxlen, nm, njt, rows,
      nstage);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_inv(const void* tpos, const void* tneg, const int* groups, const int* tiles,
               int ntiles, void* out, int B, int nring, int maxlen, int nm, int rows, int pix,
               int nstage, int real, cudaStream_t stream) {
  const int rpw = real ? 32 : 16;  // rows a warp row
  if (B < 0 || nm < 0 || ntiles < 0 || maxlen % 4 != 0 || (real != 0) != (tneg == nullptr) ||
      (rows != rpw && rows != 2 * rpw && rows != 4 * rpw) || (pix != 32 && pix != 64) ||
      nstage < 2 || nstage > 4)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || ntiles == 0) return 0;
  if (real)
    return pix == 32 ? launch_inv_nt<T, true, 2>(tpos, tneg, groups, tiles, ntiles, out, B, nring,
                                                 maxlen, nm, rows, nstage, stream)
                     : launch_inv_nt<T, true, 4>(tpos, tneg, groups, tiles, ntiles, out, B, nring,
                                                 maxlen, nm, rows, nstage, stream);
  return pix == 32 ? launch_inv_nt<T, false, 2>(tpos, tneg, groups, tiles, ntiles, out, B, nring,
                                                maxlen, nm, rows, nstage, stream)
                   : launch_inv_nt<T, false, 4>(tpos, tneg, groups, tiles, ntiles, out, B, nring,
                                                maxlen, nm, rows, nstage, stream);
}

}  // namespace

extern "C" {

// maps (B, nring, maxlen) complex, padding slots not read; groups (ngroups,
// 5) int32 rows (N, h, rings, first ring, ring stride) and tiles (ntiles, 2)
// int32 (group, first row) of ops/sht.py phase_groups / phase_tiles; the
// plan of ops/sht.py phase_plan: rows a tile (32 or 64 complex64; 16, 32
// or 64 complex128), m a tile (cols, a multiple of 8 up to 64), ring
// stages (2..4); F, G (B, nm, nring) complex for m = m0 .. m0 + nm - 1.
// Returns the first CUDA error
// (cudaErrorInvalidValue for a plan this library was not built for or
// past the shared memory).
int phase_fwd_c64(const void* maps, const int* groups, const int* tiles, int ntiles, void* F,
                  void* G, int B, int nring, int maxlen, int m0, int nm, int rows, int cols,
                  int nstage, void* stream) {
  return launch_fwd<true>(maps, groups, tiles, ntiles, F, G, B, nring, maxlen, m0, nm, rows,
                          cols, nstage, (cudaStream_t)stream);
}

int phase_fwd_c128(const void* maps, const int* groups, const int* tiles, int ntiles, void* F,
                   void* G, int B, int nring, int maxlen, int m0, int nm, int rows, int cols,
                   int nstage, void* stream) {
  return launch_fwd<false>(maps, groups, tiles, ntiles, F, G, B, nring, maxlen, m0, nm, rows,
                           cols, nstage, (cudaStream_t)stream);
}

// tpos, tneg (B, nm, nring) complex for m = 0 .. nm - 1 (tneg null: the
// real form); groups and tiles as above, the plan's rows a tile (32, 64 or
// 128 real form; 16, 32 or 64 complex), pixels a tile (32 or 64) and ring
// stages; out (B, nring, maxlen), real (real form) or complex, every slot
// written.
int phase_inv_c64(const void* tpos, const void* tneg, const int* groups, const int* tiles,
                  int ntiles, void* out, int B, int nring, int maxlen, int nm, int rows, int pix,
                  int nstage, int real, void* stream) {
  return launch_inv<float>(tpos, tneg, groups, tiles, ntiles, out, B, nring, maxlen, nm, rows,
                           pix, nstage, real, (cudaStream_t)stream);
}

int phase_inv_c128(const void* tpos, const void* tneg, const int* groups, const int* tiles,
                   int ntiles, void* out, int B, int nring, int maxlen, int nm, int rows, int pix,
                   int nstage, int real, void* stream) {
  return launch_inv<double>(tpos, tneg, groups, tiles, ntiles, out, B, nring, maxlen, nm, rows,
                            pix, nstage, real, (cudaStream_t)stream);
}

}  // extern "C"
