// Tiled Gram of a factor whose columns are formed on the fly.
//
// out[z, i, j] = sum_c X_z[i, c] conj(X_z[j, c]) for a factor X_z whose
// elements a Rows functor computes from smaller arrays: the (rows, cols)
// factor is never written to device memory.  A block owns a TILE x TILE
// output tile of one batch element z; it walks the columns in chunks of
// CW, building the chunk's X rows for its i-tile and j-tile in shared
// memory, then every thread accumulates a 4 x 4 patch of the tile in
// registers.  Shared rows are padded by one element against bank
// conflicts.  Used by signal_gram.cu (K9) and fisher_gram.cu (K13).

#pragma once

#include <cuda_runtime.h>

namespace gram {

constexpr int TILE = 64;
constexpr int CW = 16;
constexpr int THREADS = 256;  // 16 x 16, 4 x 4 outputs each

template <typename T>
struct cpx {
  T re, im;
};

template <typename T>
__device__ __forceinline__ void cmac(cpx<T>& acc, const cpx<T>& a, const cpx<T>& b) {
  acc.re += a.re * b.re;
  acc.re += a.im * b.im;
  acc.im += a.im * b.re;
  acc.im -= a.re * b.im;
}

template <typename T, typename Rows>
__global__ void __launch_bounds__(THREADS)
gram_kernel(Rows rows, cpx<T>* __restrict__ out, int nrows, int ncols) {
  __shared__ cpx<T> xi[TILE][CW + 1];
  __shared__ cpx<T> xj[TILE][CW + 1];
  const int z = blockIdx.z;
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  cpx<T> acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = cpx<T>{(T)0, (T)0};

  for (int c0 = 0; c0 < ncols; c0 += CW) {
    for (int e = tid; e < TILE * CW; e += THREADS) {
      const int rr = e / CW;
      const int cc = e % CW;
      const int c = c0 + cc;
      const cpx<T> zero{(T)0, (T)0};
      xi[rr][cc] = (i0 + rr < nrows && c < ncols) ? rows(z, i0 + rr, c) : zero;
      xj[rr][cc] = (j0 + rr < nrows && c < ncols) ? rows(z, j0 + rr, c) : zero;
    }
    __syncthreads();
#pragma unroll 4
    for (int cc = 0; cc < CW; ++cc) {
      cpx<T> av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = xi[ty + 16 * a][cc];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = xj[tx + 16 * b][cc];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) cmac(acc[a][b], av[a], bv[b]);
    }
    __syncthreads();
  }

  cpx<T>* o = out + (size_t)z * nrows * nrows;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx + 16 * b;
      if (i < nrows && j < nrows) o[(size_t)i * nrows + j] = acc[a][b];
    }
  }
}

template <typename T, typename Rows>
int launch_gram(const Rows& rows, void* out, int nrows, int ncols, int nbatch,
                cudaStream_t stream) {
  const int nt = (nrows + TILE - 1) / TILE;
  dim3 grid(nt, nt, nbatch);
  gram_kernel<T, Rows><<<grid, THREADS, 0, stream>>>(
      rows, static_cast<cpx<T>*>(out), nrows, ncols);
  return (int)cudaGetLastError();
}

}  // namespace gram
