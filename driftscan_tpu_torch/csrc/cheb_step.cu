// K17: one step of the top-band engine's Chebyshev filter.
//
// Replaces the fused XLA program of driftscan_tpu/ops/fpencil.py:_cheb_apply
// (each application of t(H) = (2/b) H - I with H = Y Y^H, never formed, and
// the three-term recurrence with its running rescale).  Per batch element z
// (an m-mode), with W = Y^H V_k formed beforehand by a library product:
//
//   V_out[z] = alpha[z] (Y[z] W[z]) + beta V_k[z] + gamma V_p[z]
//   amax[z]  = max over V_out[z] of max(|Re|, |Im|)
//
// Y (M, n, K), W (M, K, k), V_k, V_p, V_out (M, n, k) complex128, row-major;
// alpha (M,) float64 on the card.  The first application of the filter is
// (alpha, beta, gamma) = (2/b, -1, 0) with no V_p; a recurrence step is
// (4/b, -2, -1).  amax is the running scale of the recurrence: the caller
// multiplies both iterates by 1 / (amax + 1e-30), as the JAX program does.
//
// What bounds it on an H100: at the ns2 telescope's full size (n 3200,
// K 3200, k 400) the product's 8 n K k = 32.8 GFLOP against 0.2 GB of
// inputs and output, so arithmetic (0.49 ms at the 67 TFLOP/s float64
// peak of the tensor cores); at the bench cylinder's (M 8, n 352, K 352,
// k 44) memory (24 MB, 7 us).
//
// The design:
//   * the product on the float64 tensor cores (mma.sync m16n8k4.f64): a
//     complex product is four real ones on the Re and Im fragments, Re +=
//     Yr Wr + (-Yi) Wi and Im += Yr Wi + Yi Wr, -Yi formed once a
//     fragment, Re and Im accumulators in registers; 8 n K k flops, no
//     three-product form (its cancellation would cost digits).  sm_90's
//     m16n8k8 shape, tried, needs larger fragments and measured slower at
//     every tile (PERF.md);
//   * a block owns a BM x BN output tile of one z: WR x WC warps of MT x NT
//     mma tiles (16 x 8 outputs each), and WKS such groups splitting the
//     depth, each taking DK of every staged slab of SD = DK * WKS; the
//     groups' partial tiles are summed in shared memory in group order,
//     so a step stays one launch and two launches give the same bits;
//   * Y and W slabs (BM x SD, SD x BN) go to a ring of NSTAGE shared-memory
//     stages by cp.async, NSTAGE - 1 slabs ahead of the products, one
//     barrier a slab; ragged n, K and k are zero-filled as they are staged.
//     The staged Y row is swizzled (its 16-byte chunk d at d ^ 4 on odd
//     rows), the staged W row too (column c at c ^ 2 (d % 4)), so that the
//     staging writes and the fragment reads meet no bank conflict;
//   * the host picks the tile (ops/cheb.py plan): at ns2 128 x 80 (125
//     blocks for 132 SMs, one wave), at the bench cylinder 32 x 48 with
//     the depth split four ways (88 blocks, k 44 padded to 48).  The
//     column tiles of a row panel are neighbours in the grid, so each Y
//     panel comes from device memory about once and from L2 after;
//   * the epilogue keeps the JAX program's order, alpha (Y W), then
//     + beta V_k, then + gamma V_p, and reduces the block's largest part
//     in registers and shared memory; amax[z], zeroed by the entry point
//     on the stream, is raised by one integer atomicMax on the bits of
//     that non-negative double (the bits of non-negative doubles order as
//     their values, a NaN's above all, so the result is the same in any
//     order, bit for bit).
//
// Plain version: driftscan_tpu_torch.ops.cheb.cheb_step_ref.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "tma_ring.cuh"

namespace {

constexpr int DK = 8;      // depth a warp takes from each staged slab
constexpr int NSTAGE = 4;  // slabs in the cp.async ring

// One tile of ops/cheb.py's TILES: a warp owns MT x NT mma tiles, a block
// WR x WC warps of them and WKS such groups along the depth.
template <int MT_, int NT_, int WR_, int WC_, int WKS_>
struct Tile {
  static constexpr int MT = MT_, NT = NT_, WR = WR_, WC = WC_, WKS = WKS_;
  static constexpr int BM = WR * 16 * MT, BN = WC * 8 * NT, SD = DK * WKS;
  static constexpr int THREADS = 32 * WR * WC * WKS;
  static constexpr int Y_ELEMS = BM * SD, W_ELEMS = SD * BN;
  static constexpr int STAGE = Y_ELEMS + W_ELEMS;  // double2 a stage
  static constexpr int PART = (WKS - 1) * BM * BN;  // double2 of the split's partial tiles
  static constexpr size_t SMEM =
      16 * (size_t)(NSTAGE * STAGE > PART ? NSTAGE * STAGE : PART);
};

// max that keeps a NaN (the JAX max propagates one)
__device__ __forceinline__ double nanmax(double a, double b) {
  return (b > a || b != b) ? b : a;
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
    cheb_step_kernel(const double2* __restrict__ Y, const double2* __restrict__ W,
                     const double2* __restrict__ Vk, const double2* __restrict__ Vp,
                     const double* __restrict__ alpha, double beta, double gamma,
                     double2* __restrict__ out, unsigned long long* __restrict__ amax, int n,
                     int K, int k) {
  constexpr int MT = T::MT, NT = T::NT, BM = T::BM, BN = T::BN, SD = T::SD;
  constexpr int WPOS = T::WR * T::WC;  // warps of one depth group
  extern __shared__ __align__(16) double2 smem[];
  __shared__ double red[T::THREADS / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ks = warp / WPOS, wpos = warp % WPOS;
  const int wrow = (wpos / T::WC) * 16 * MT;  // warp's first row in the tile
  const int wcol = (wpos % T::WC) * 8 * NT;   // its first column
  const int z = blockIdx.z, row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const double2* y = Y + (size_t)z * n * K;
  const double2* w = W + (size_t)z * K * k;

  // slab q (depth q * SD ...) into stage s; past an edge, zeros
  auto stage = [&](int q, int s) {
    const int d0 = q * SD;
    double2* ys = smem + s * T::STAGE;
    double2* ws = ys + T::Y_ELEMS;
#pragma unroll
    for (int i = 0; i < (T::Y_ELEMS + T::THREADS - 1) / T::THREADS; ++i) {
      const int e = tid + i * T::THREADS;
      if (T::Y_ELEMS % T::THREADS == 0 || e < T::Y_ELEMS) {
        const int r = e / SD, d = e % SD;
        const int gr = row0 + r, gd = d0 + d;
        const bool ok = gr < n && gd < K;
        mma::cp_async<16>(ys + r * SD + (d ^ ((r & 1) << 2)), ok ? y + (size_t)gr * K + gd : y,
                          ok);
      }
    }
#pragma unroll
    for (int i = 0; i < (T::W_ELEMS + T::THREADS - 1) / T::THREADS; ++i) {
      const int e = tid + i * T::THREADS;
      if (T::W_ELEMS % T::THREADS == 0 || e < T::W_ELEMS) {
        const int d = e / BN, c = e % BN;
        const int gd = d0 + d, gc = col0 + c;
        const bool ok = gd < K && gc < k;
        mma::cp_async<16>(ws + d * BN + (c ^ ((d & 3) << 1)), ok ? w + (size_t)gd * k + gc : w,
                          ok);
      }
    }
    mma::cp_async_commit();
  };

  double acc_re[MT][NT][4], acc_im[MT][NT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc_re[a][c][r] = acc_im[a][c][r] = 0.0;

  // this thread's swizzles: its A rows have the parity of g, its B rows
  // the residue t mod 4
  const int a_x = (g & 1) << 2;
  const int b_col = g ^ (t << 1);

  const int nslab = (K + SD - 1) / SD;
  // the first NSTAGE - 1 slabs go out ahead (an empty group past the end
  // keeps the count of groups)
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nslab) stage(s, s);
    else mma::cp_async_commit();
  }
  for (int q = 0; q < nslab; ++q) {
    mma::cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // slab q landed; every warp is past slab q - 1's products
    const int nq = q + NSTAGE - 1;
    if (nq < nslab) stage(nq, nq % NSTAGE);
    else mma::cp_async_commit();
    const double2* ys = smem + (q % NSTAGE) * T::STAGE + wrow * SD + ks * DK;
    const double2* ws = smem + (q % NSTAGE) * T::STAGE + T::Y_ELEMS + ks * DK * BN + wcol + b_col;
#pragma unroll
    for (int kk = 0; kk < DK; kk += 4) {
      double ar[MT][2], ai[MT][2], an[MT][2], br[NT], bi[NT];
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const double2 v = ys[(16 * a + 8 * h + g) * SD + ((kk + t) ^ a_x)];
          ar[a][h] = v.x;
          ai[a][h] = v.y;
          an[a][h] = -v.y;
        }
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        const double2 v = ws[(kk + t) * BN + 8 * c];
        br[c] = v.x;
        bi[c] = v.y;
      }
      // the first product of every accumulator, then the second, so that
      // no product waits on the one before it in the same accumulator
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int c = 0; c < NT; ++c) {
          mma::dmma_16x8x4(acc_re[a][c], ar[a][0], ar[a][1], br[c]);
          mma::dmma_16x8x4(acc_im[a][c], ar[a][0], ar[a][1], bi[c]);
        }
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int c = 0; c < NT; ++c) {
          mma::dmma_16x8x4(acc_re[a][c], an[a][0], an[a][1], bi[c]);
          mma::dmma_16x8x4(acc_im[a][c], ai[a][0], ai[a][1], br[c]);
        }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // every warp past its last product: the ring is free

  if constexpr (T::WKS > 1) {
    // depth groups 1.. leave their partial tiles in fragment order; group
    // 0 adds them in group order
    constexpr int FRAG = MT * NT * 4 * 32;  // double2 a warp's tile
    double2* part = smem + wpos * FRAG;
    if (ks > 0) {
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int c = 0; c < NT; ++c)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            part[(ks - 1) * WPOS * FRAG + ((a * NT + c) * 4 + r) * 32 + lane] =
                make_double2(acc_re[a][c][r], acc_im[a][c][r]);
    }
    __syncthreads();
    if (ks == 0) {
      for (int s = 0; s < T::WKS - 1; ++s)
#pragma unroll
        for (int a = 0; a < MT; ++a)
#pragma unroll
          for (int c = 0; c < NT; ++c)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const double2 v = part[s * WPOS * FRAG + ((a * NT + c) * 4 + r) * 32 + lane];
              acc_re[a][c][r] += v.x;
              acc_im[a][c][r] += v.y;
            }
    }
  }

  double big = 0.0;
  if (ks == 0) {
    const double al = alpha[z];
    const size_t base = (size_t)z * n * k;
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int c = 0; c < NT; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = row0 + wrow + 16 * a + g + 8 * (r >> 1);
          const int col = col0 + wcol + 8 * c + 2 * t + (r & 1);
          if (row < n && col < k) {
            const size_t o = base + (size_t)row * k + col;
            const double2 vk = Vk[o];
            double re = al * acc_re[a][c][r] + beta * vk.x;
            double im = al * acc_im[a][c][r] + beta * vk.y;
            if (Vp != nullptr) {
              const double2 vp = Vp[o];
              re += gamma * vp.x;
              im += gamma * vp.y;
            }
            out[o] = make_double2(re, im);
            big = nanmax(big, nanmax(fabs(re), fabs(im)));
          }
        }
  }

  // the block's largest part: warp shuffles, then the warps' values
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) big = nanmax(big, __shfl_xor_sync(0xffffffffu, big, s));
  if (lane == 0) red[warp] = big;
  __syncthreads();
  if (tid == 0) {
    double m = red[0];
#pragma unroll
    for (int wi = 1; wi < T::THREADS / 32; ++wi) m = nanmax(m, red[wi]);
    atomicMax(amax + z, (unsigned long long)__double_as_longlong(m));
  }
}

struct Args {
  const void *Y, *W, *Vk, *Vp, *alpha;
  double beta, gamma;
  void *out, *amax;
  int M, n, K, k;
  cudaStream_t stream;
};

template <class T>
int launch(const Args& a) {
  constexpr auto kernel = cheb_step_kernel<T>;
  cudaError_t e = ring::allow_smem<kernel>(T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.k + T::BN - 1) / T::BN, (a.n + T::BM - 1) / T::BM, a.M);
  kernel<<<grid, T::THREADS, T::SMEM, a.stream>>>(
      (const double2*)a.Y, (const double2*)a.W, (const double2*)a.Vk, (const double2*)a.Vp,
      (const double*)a.alpha, a.beta, a.gamma, (double2*)a.out, (unsigned long long*)a.amax,
      a.n, a.K, a.k);
  return (int)cudaGetLastError();
}

template <class T>
bool is(int mt, int nt, int wr, int wc, int wks) {
  return mt == T::MT && nt == T::NT && wr == T::WR && wc == T::WC && wks == T::WKS;
}

// ops/cheb.py's TILES, in its order
using T0 = Tile<2, 5, 4, 2, 1>;  // 128 x 80
using T1 = Tile<2, 4, 2, 2, 2>;  // 64 x 64, depth split 2
using T2 = Tile<1, 6, 2, 1, 4>;  // 32 x 48, depth split 4
using T3 = Tile<1, 4, 2, 1, 4>;  // 32 x 32, depth split 4

}  // namespace

extern "C" {

// V_out and amax as above with the tile (mt, nt, wr, wc, wks) of
// ops/cheb.py's plan; Vp may be null
// (gamma then unused).  amax (M 8-byte words) is zeroed here, on the
// stream, before the launch.  Returns the first CUDA error
// (cudaErrorInvalidValue for a tile this library was not built with or M
// past the grid's 65535).
int cheb_step_c128(const void* Y, const void* W, const void* Vk, const void* Vp,
                   const void* alpha, double beta, double gamma, void* out, void* amax, int M,
                   int n, int K, int k, int mt, int nt, int wr, int wc, int wks,
                   void* stream) {
  if (M <= 0 || n <= 0 || k <= 0) return 0;
  if (M > 65535) return (int)cudaErrorInvalidValue;
  const Args a{Y, W, Vk, Vp, alpha, beta, gamma, out, amax, M, n, K, k, (cudaStream_t)stream};
  const cudaError_t e = cudaMemsetAsync(amax, 0, (size_t)M * 8, a.stream);
  if (e != cudaSuccess) return (int)e;
#define CHEB_TRY(T) \
  if (is<T>(mt, nt, wr, wc, wks)) return launch<T>(a);
  CHEB_TRY(T0)
  CHEB_TRY(T1)
  CHEB_TRY(T2)
  CHEB_TRY(T3)
#undef CHEB_TRY
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
