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
// k 44) memory (24 MB, 7 us).  This first design is a plain one: 64 x 32
// output tiles a block, 16-deep slices of Y and W staged in shared memory,
// four rows by two columns of complex accumulators a thread, float64 FMA
// on the CUDA cores (half the float64 tensor-core peak); the epilogue adds
// the two iterates, writes V_out and reduces the block's largest part in
// registers and shared memory, then raises amax[z] with one integer
// atomicMax on the bits of that non-negative double (the bits of
// non-negative doubles order as their values, so the result is the same
// in any order, bit for bit).
//
// Plain version: driftscan_tpu_torch.ops.cheb.cheb_step_ref.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // output rows a block
constexpr int BN = 32;   // output columns a block
constexpr int BK = 16;   // depth of a staged slice
constexpr int TX = 16;   // threads along the columns
constexpr int TY = 16;   // threads along the rows
constexpr int RM = BM / TY;  // rows a thread (strided by TY)
constexpr int RN = BN / TX;  // columns a thread (strided by TX)
constexpr int THREADS = TX * TY;

// max that keeps a NaN (the JAX max propagates one)
__device__ __forceinline__ double nanmax(double a, double b) {
  return (b > a || b != b) ? b : a;
}

__global__ void __launch_bounds__(THREADS)
    cheb_step_kernel(const double2* __restrict__ Y, const double2* __restrict__ W,
                     const double2* __restrict__ Vk, const double2* __restrict__ Vp,
                     const double* __restrict__ alpha, double beta, double gamma,
                     double2* __restrict__ out, unsigned long long* __restrict__ amax, int n,
                     int K, int k) {
  __shared__ double2 ys[BK][BM];  // Y slice, k-major
  __shared__ double2 ws[BK][BN];  // W slice
  __shared__ double red[THREADS / 32];

  const int z = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const double2* y = Y + (size_t)z * n * K;
  const double2* w = W + (size_t)z * K * k;

  double2 acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = make_double2(0.0, 0.0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Y slice: 64 rows x 16 deep, neighbouring threads on neighbouring depth
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, d = e % BK;
      const int gr = row0 + r, gd = k0 + d;
      ys[d][r] = (gr < n && gd < K) ? y[(size_t)gr * K + gd] : make_double2(0.0, 0.0);
    }
    // W slice: 16 deep x 32 columns, neighbouring threads on neighbouring columns
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int d = e / BN, c = e % BN;
      const int gd = k0 + d, gc = col0 + c;
      ws[d][c] = (gd < K && gc < k) ? w[(size_t)gd * k + gc] : make_double2(0.0, 0.0);
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < BK; ++d) {
      double2 a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = ys[d][ty + TY * i];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = ws[d][tx + TX * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          acc[i][j].x = fma(a[i].x, b[j].x, acc[i][j].x);
          acc[i][j].x = fma(-a[i].y, b[j].y, acc[i][j].x);
          acc[i][j].y = fma(a[i].x, b[j].y, acc[i][j].y);
          acc[i][j].y = fma(a[i].y, b[j].x, acc[i][j].y);
        }
    }
    __syncthreads();
  }

  const double al = alpha[z];
  const size_t base = (size_t)z * n * k;
  double big = 0.0;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = row0 + ty + TY * i;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = col0 + tx + TX * j;
      if (r < n && c < k) {
        const size_t o = base + (size_t)r * k + c;
        const double2 vk = Vk[o];
        double re = al * acc[i][j].x + beta * vk.x;
        double im = al * acc[i][j].y + beta * vk.y;
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
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = big;
  __syncthreads();
  if (threadIdx.x == 0) {
    double m = red[0];
#pragma unroll
    for (int wi = 1; wi < THREADS / 32; ++wi) m = nanmax(m, red[wi]);
    atomicMax(amax + z, (unsigned long long)__double_as_longlong(m));
  }
}

}  // namespace

extern "C" {

// V_out and amax as above; Vp may be null (gamma then unused).  amax must
// hold zeros (the bits of +0.0) on entry.  Returns the launch's CUDA error.
int cheb_step_c128(const void* Y, const void* W, const void* Vk, const void* Vp,
                   const void* alpha, double beta, double gamma, void* out, void* amax, int M,
                   int n, int K, int k, void* stream) {
  if (M <= 0 || n <= 0 || k <= 0) return 0;
  const dim3 grid((k + BN - 1) / BN, (n + BM - 1) / BM, M);
  cheb_step_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const double2*)Y, (const double2*)W, (const double2*)Vk, (const double2*)Vp,
      (const double*)alpha, beta, gamma, (double2*)out, (unsigned long long*)amax, n, K, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
