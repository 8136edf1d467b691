// The map pass shared by K2-host (host_vis.cu: beams evaluated on the host,
// staged from device arrays) and K1+K2 (bank_vis.cu: cylinder beams evaluated
// in the block from bank rows).  For unit u, pairing the batch's unique beams
// i = ii[u], j = jj[u] at baseline uv3[u],
//
//   V_u(n) = h(n) B_i(n) conj(B_j(n)) e^{2 pi i u.n} / sqrt(Omega_i Omega_j)
//
// or, for (theta_hat, phi_hat) field patterns (NCOMP 2), its Stokes I, Q, U,
// V (I = tc (tt + pp), Q = tc (tt - pp), U = tc (tp + pt), V = i tc (tp - pt)
// with tt = B_it conj(B_jt), ..., tc = h e^{2 pi i u.n} / sqrt(Omega_i
// Omega_j)).
//
// A beam source S says where B_b(n) comes from:
//   using ET = one beam component at one pixel (T, or T's vec2 when complex);
//   kCart    -- eval reads the pixel's cartesian n;
//   kAllRows -- the solid-angle pass sums every beam in one block, reading
//               the pixel grid once (beams formed in the block), instead of
//               one block per (pixel block, beam) (beams read from arrays);
//   eval(b, p, cx, cy, cz, h, v) -- the NCOMP components of beam b at pixel p.
//
// Three launches a call, on the caller's stream:
//   1. omega_partial, pixel blocks of OTILE: each block's sum of |B|^2 h
//      (both components of a field pattern), a fixed shuffle tree, into a
//      (beams, blocks) scratch;
//   2. omega_rows, one block a beam: the row of partials summed in a fixed
//      order, times the pixel area: Omega_b.  No atomics, so the maps
//      repeat bitwise from run to run;
//   3. map_kernel, pixel-outer and unit-inner: one block a tile of TILE
//      pixels (THREADS threads x PPT).  Each thread loads its pixels' cart
//      and horizon once into registers and stages its pixels of the batch's
//      unique beams in shared memory once; the block then walks every unit
//      of the batch and writes that unit's map over its pixels.  Where the
//      beams do not fit one shared-memory stage (nstage beams, chosen by
//      ops/kernels.py host_vis_stage), they are staged in groups of nstage:
//      each unit is formed in the group that holds its beam i, and its beam
//      j, if another group holds it, is taken from the source in place.
//      Each thread reads back only its own staged pixels, so staging needs
//      no barrier.  Pixels with h = 0 (below the horizon, and the ring
//      padding) stage nothing and are written as zeros.
//
// The fringe: turns = u.n in float64 (as the plain versions form them),
// reduced to [-1/2, 1/2), then one sincospi of 2 frac (sincospif on a
// float32 grid, which keeps float64 turns): one range reduction gives both
// values, with no multiplication by 2 pi.  Each (re, im) leaves as one
// float2 / double2 streaming store (__stcs): the maps are never read back
// here and are many times the L2 cache.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vismap {

constexpr int THREADS = 256;
constexpr int PPT = 2;                  // pixels a thread in the map pass
constexpr int TILE = THREADS * PPT;     // pixels a block (HOST_VIS_TILE in ops/kernels.py)
constexpr int UTILE = THREADS;          // units staged per round
constexpr int OPPT = 4;                 // pixels a thread in the Omega pass
constexpr int OTILE = THREADS * OPPT;   // (HOST_VIS_OMEGA_TILE in ops/kernels.py)
constexpr size_t SMEM_MAX = 232448;     // the H100's opt-in shared memory a block

template <typename T> struct vec2;
template <> struct vec2<float> { using type = float2; };
template <> struct vec2<double> { using type = double2; };

// One beam component at one pixel: T for a real beam, (re, im) for a
// complex one.
template <typename T, bool CPLX> struct Elem {
  using type = typename vec2<T>::type;
  __device__ static T re(type v) { return v.x; }
  __device__ static T im(type v) { return v.y; }
  __device__ static T norm(type v) { return v.x * v.x + v.y * v.y; }
};
template <typename T> struct Elem<T, false> {
  using type = T;
  __device__ static T re(T v) { return v; }
  __device__ static T im(T) { return T(0); }
  __device__ static T norm(T v) { return v * v; }
};

__device__ __forceinline__ void sincos_pi(float x, float* s, float* c) { sincospif(x, s, c); }
__device__ __forceinline__ void sincos_pi(double x, double* s, double* c) { sincospi(x, s, c); }

__device__ __forceinline__ void store_cs(float* p, float re, float im) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(re, im));
}
__device__ __forceinline__ void store_cs(double* p, double re, double im) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(re, im));
}

// Sum over the block in a fixed order: a shuffle tree in each warp, then
// the warps' sums in order.  The result is valid in thread 0; the block
// may call it again after a barrier.
template <typename T>
__device__ T block_sum(T v, T* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T s = T(0);
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;
}

// Pass 1: part[b, blk] = sum over the block's pixels of |B_b|^2 h, for beam
// blockIdx.y, or for every beam where the source forms them (kAllRows).
template <typename T, bool CPLX, int NCOMP, class S>
__global__ void __launch_bounds__(THREADS)
omega_partial(S src, const T* __restrict__ cart, const T* __restrict__ hor,
              T* __restrict__ part, long long npix, int nb) {
  using E = Elem<T, CPLX>;
  __shared__ T red[THREADS / 32];
  const long long p0 = (long long)blockIdx.x * OTILE + threadIdx.x;
  T cx[OPPT], cy[OPPT], cz[OPPT], h[OPPT];
#pragma unroll
  for (int k = 0; k < OPPT; ++k) {
    const long long p = p0 + k * THREADS;
    cx[k] = cy[k] = cz[k] = h[k] = T(0);
    if (p < npix) {
      h[k] = hor[p];
      if (S::kCart) {
        cx[k] = cart[3 * p];
        cy[k] = cart[3 * p + 1];
        cz[k] = cart[3 * p + 2];
      }
    }
  }
  const int b0 = S::kAllRows ? 0 : (int)blockIdx.y;
  const int b1 = S::kAllRows ? nb : b0 + 1;
  for (int b = b0; b < b1; ++b) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < OPPT; ++k) {
      if (h[k] == T(0)) continue;
      typename E::type v[NCOMP];
      src.eval(b, p0 + k * THREADS, cx[k], cy[k], cz[k], h[k], v);
      T w = E::norm(v[0]);
      if (NCOMP == 2) w += E::norm(v[1]);
      acc += w * h[k];
    }
    const T s = block_sum(acc, red);
    if (threadIdx.x == 0) part[(long long)b * gridDim.x + blockIdx.x] = s;
    if (S::kAllRows) __syncthreads();  // red is rewritten by the next beam's sum
  }
}

// Pass 2: omega[b] = pxarea * sum of part[b, :nblk].
template <typename T>
__global__ void __launch_bounds__(THREADS)
omega_rows(const T* __restrict__ part, T* __restrict__ omega, int nblk, T pxarea) {
  __shared__ T red[THREADS / 32];
  const T* row = part + (long long)blockIdx.x * nblk;
  T acc = T(0);
  for (int c = threadIdx.x; c < nblk; c += THREADS) acc += row[c];
  const T s = block_sum(acc, red);
  if (threadIdx.x == 0) omega[blockIdx.x] = s * pxarea;
}

// Pass 3: the maps.  out is (nu, npol, npix) interleaved (re, im) (npol 1
// for the scalar form).
template <typename T, bool CPLX, int NCOMP, class S>
__global__ void __launch_bounds__(THREADS)
map_kernel(S src, const T* __restrict__ cart, const T* __restrict__ hor,
           const T* __restrict__ omega, const long long* __restrict__ ii,
           const long long* __restrict__ jj, const double* __restrict__ uv3, T* __restrict__ out,
           long long npix, int nu, int nb, int npol, int nstage) {
  using E = Elem<T, CPLX>;
  using ET = typename E::type;
  extern __shared__ __align__(16) unsigned char smem[];
  // staged beams: [slot][component][pixel of the tile]
  ET* s_beam = reinterpret_cast<ET*>(smem);
  double* s_uv = reinterpret_cast<double*>(smem + (size_t)nstage * NCOMP * TILE * sizeof(ET));
  T* s_scale = reinterpret_cast<T*>(s_uv + 3 * UTILE);
  int* s_i = reinterpret_cast<int*>(s_scale + UTILE);
  int* s_j = s_i + UTILE;

  const int tid = threadIdx.x;
  const long long tile0 = (long long)blockIdx.x * TILE;

  T cx[PPT], cy[PPT], cz[PPT], h[PPT];
  bool live[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const long long p = tile0 + k * THREADS + tid;
    live[k] = p < npix;
    cx[k] = cy[k] = cz[k] = h[k] = T(0);
    if (live[k]) {
      cx[k] = cart[3 * p];
      cy[k] = cart[3 * p + 1];
      cz[k] = cart[3 * p + 2];
      h[k] = hor[p];
    }
  }

  for (int g0 = 0; g0 < nb; g0 += nstage) {
    const int g1 = min(nb, g0 + nstage);
    // each thread stages its own pixels of the group's beams
    for (int b = g0; b < g1; ++b) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (!live[k] || h[k] == T(0)) continue;
        ET v[NCOMP];
        src.eval(b, tile0 + k * THREADS + tid, cx[k], cy[k], cz[k], h[k], v);
#pragma unroll
        for (int c = 0; c < NCOMP; ++c)
          s_beam[((b - g0) * NCOMP + c) * TILE + k * THREADS + tid] = v[c];
      }
    }

    for (int u0 = 0; u0 < nu; u0 += UTILE) {
      const int un = min(UTILE, nu - u0);
      __syncthreads();  // the previous round's unit table is no longer read
      if (tid < un) {
        const int u = u0 + tid;
        const int bi = (int)ii[u], bj = (int)jj[u];
        s_i[tid] = bi;
        s_j[tid] = bj;
        s_scale[tid] = T(1) / sqrt(omega[bi] * omega[bj]);
        s_uv[3 * tid] = uv3[3 * (long long)u];
        s_uv[3 * tid + 1] = uv3[3 * (long long)u + 1];
        s_uv[3 * tid + 2] = uv3[3 * (long long)u + 2];
      }
      __syncthreads();

      for (int e = 0; e < un; ++e) {
        const int bi = s_i[e];
        if (bi < g0 || bi >= g1) continue;  // formed in the group holding beam i
        const int bj = s_j[e];
        const bool j_staged = bj >= g0 && bj < g1;
        const T scale = s_scale[e];
        const double u_x = s_uv[3 * e], u_y = s_uv[3 * e + 1], u_z = s_uv[3 * e + 2];
        T* ou = out + (long long)(u0 + e) * npol * npix * 2;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (!live[k]) continue;
          const int q = k * THREADS + tid;
          const long long p = tile0 + q;
          if (h[k] == T(0)) {
            for (int s = 0; s < npol; ++s) store_cs(ou + 2 * ((long long)s * npix + p), T(0), T(0));
            continue;
          }
          const double turns = (double)cx[k] * u_x + (double)cy[k] * u_y + (double)cz[k] * u_z;
          const double frac = turns - floor(turns + 0.5);
          T sn, cs;
          sincos_pi((T)(2.0 * frac), &sn, &cs);
          const T amp = h[k] * scale;
          cs *= amp;
          sn *= amp;

          ET bi_c[NCOMP], bj_c[NCOMP];
#pragma unroll
          for (int c = 0; c < NCOMP; ++c) bi_c[c] = s_beam[((bi - g0) * NCOMP + c) * TILE + q];
          if (j_staged) {
#pragma unroll
            for (int c = 0; c < NCOMP; ++c) bj_c[c] = s_beam[((bj - g0) * NCOMP + c) * TILE + q];
          } else {
            src.eval(bj, p, cx[k], cy[k], cz[k], h[k], bj_c);
          }
          // a conj(b) for components x of beam i and y of beam j
          auto prod = [&](int x, int y, T& re, T& im) {
            const T ar = E::re(bi_c[x]), br = E::re(bj_c[y]);
            if (CPLX) {
              const T ai = E::im(bi_c[x]), bim = E::im(bj_c[y]);
              re = ar * br + ai * bim;
              im = ai * br - ar * bim;
            } else {
              re = ar * br;
              im = T(0);
            }
          };
          // (ar + i ai)(cs + i sn), stored at Stokes component s
          auto put = [&](int s, T ar, T ai) {
            store_cs(ou + 2 * ((long long)s * npix + p), ar * cs - ai * sn, ar * sn + ai * cs);
          };
          if (NCOMP == 1) {
            T pr, pi;
            prod(0, 0, pr, pi);
            put(0, pr, pi);
          } else {
            T ttr, tti, ppr, ppi;
            prod(0, 0, ttr, tti);
            prod(1, 1, ppr, ppi);
            put(0, ttr + ppr, tti + ppi);
            if (npol > 1) put(1, ttr - ppr, tti - ppi);
            if (npol > 2) {
              T tpr, tpi, ptr_, pti;
              prod(0, 1, tpr, tpi);
              prod(1, 0, ptr_, pti);
              put(2, tpr + ptr_, tpi + pti);
              if (npol > 3) put(3, pti - tpi, tpr - ptr_);
            }
          }
        }
      }
    }
    // the next group's staging overwrites slots that only this thread reads
  }
}

// The three launches on `stream`.  scratch holds scratch_len values of T:
// the (nb, nblk) Omega partials, then the nb solid angles.
template <typename T, bool CPLX, int NCOMP, class S>
int launch(S src, const void* cart, const void* hor, const void* ii, const void* jj,
           const void* uv3, void* out, void* scratch, long long scratch_len, double pxarea,
           long long npix, int nu, int nb, int npol, int nstage, cudaStream_t stream) {
  using ET = typename Elem<T, CPLX>::type;
  if (npix <= 0 || nu <= 0) return 0;
  const long long nblk = (npix + OTILE - 1) / OTILE;
  if (nb < 1 || nstage < 1 || npol < 1 || npol > (NCOMP == 1 ? 1 : 4) || nblk > 0x7fffffffLL ||
      nb > 65535 || scratch_len < (long long)nb * (nblk + 1))
    return (int)cudaErrorInvalidValue;
  const int stage = nstage < nb ? nstage : nb;
  const size_t smem = (size_t)stage * NCOMP * TILE * sizeof(ET) +
                      (size_t)UTILE * (3 * sizeof(double) + sizeof(T) + 2 * sizeof(int));
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;

  T* part = static_cast<T*>(scratch);
  T* omega = part + (long long)nb * nblk;
  omega_partial<T, CPLX, NCOMP, S><<<dim3((unsigned)nblk, S::kAllRows ? 1 : nb), THREADS, 0,
                                     stream>>>(src, (const T*)cart, (const T*)hor, part, npix, nb);
  omega_rows<T><<<nb, THREADS, 0, stream>>>(part, omega, (int)nblk, (T)pxarea);

  auto kernel = map_kernel<T, CPLX, NCOMP, S>;
  // the shared-memory opt-in, once per device
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= 64 || !smem_set[dev])) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_MAX);
    if (e == cudaSuccess && dev < 64) smem_set[dev] = true;
  }
  if (e != cudaSuccess) return (int)e;
  const long long ntile = (npix + TILE - 1) / TILE;
  kernel<<<(unsigned)ntile, THREADS, smem, stream>>>(
      src, (const T*)cart, (const T*)hor, omega, (const long long*)ii, (const long long*)jj,
      (const double*)uv3, (T*)out, npix, nu, nb, npol, stage);
  return (int)cudaGetLastError();
}

}  // namespace vismap
