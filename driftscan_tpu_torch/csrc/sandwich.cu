// K15a: the projection sandwich of the product files' covariance builds.
//
// Replaces the JAX programs driftscan_tpu/ops/projections.py
// _band_proj_native ("kfl,blfh,qhl->bkq", every band's C_l projected into
// the KL basis at one m) and _proj_sky_native[_m] ("fapl,pqlfg,gbql->fagb",
// a sky covariance projected into the SVD basis).  Both are, per batch item
// b with its own operands (x, y, c picked by index arrays),
//
//   out[b, i, j] = sum_l sum_{c, d} X[i, c, l] C[l, c, d] conj(Y[j, d, l])
//
// X (n, Cc, nl) and Y (m, Cd, nl) complex, C real.  C arrives transposed to
// (Cd, Cc, nl) so that every operand is contiguous along l.  X and Y may
// differ (the sky form pairs two frequencies), so the result is not assumed
// Hermitian and every tile is computed.
//
// XLA writes the (b, i, l, d) intermediate T = X C to device memory and
// contracts it in a second program.  Here one block owns a 64 x 64 output
// tile of one batch item and walks chunks of 16 consecutive l of one d: it
// forms that chunk of T = X C in shared memory (each entry a short sum over
// c, X and C read through L1/L2), stages the matching chunk of Y, and
// multiplies them at once on the CUDA cores, 4 x 4 complex accumulators a
// thread.  T never reaches device memory.
//
// What bounds it on an H100: arithmetic.  Per batch item the work is
// nl (4 n Cc Cd + 8 n m Cd) flops against (n Cc + m Cd) nl + n m complex
// numbers moved; at the band form's n = m = 352, Cc = Cd = 8, nl = 230 that
// is 1.9 GFLOP for 1.9 MB.  complex128 runs on the float64 CUDA cores,
// complex64 on the float32 ones; T is re-formed once per tile column
// (m / 64 times), which adds Cc / 128 of the main product (6% at Cc = 8).
// The product files' KL bases are small (tens of modes per m), so a launch
// has few tiles: the (d, l) chunks are split across nsplit blocks per tile
// (the wrapper picks nsplit to fill the card), each writing a partial tile,
// and a second kernel adds the partials in a fixed order, so the result
// does not depend on the schedule.  A tensor-core version is a later step.
//
// Plain version: driftscan_tpu_torch.ops.projections.sandwich_ref.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;      // output tile edge
constexpr int KC = 16;        // (d, l) columns per chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int PAD = TILE + 1;

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
sandwich_kernel(const T* __restrict__ X, const T* __restrict__ Y, const T* __restrict__ Ct,
                T* __restrict__ out, const int* __restrict__ ix, const int* __restrict__ iy,
                const int* __restrict__ ic, int B, int n, int m, int Cc, int Cd, int nl,
                int cps) {
  __shared__ T t_re[KC][PAD], t_im[KC][PAD], y_re[KC][PAD], y_im[KC][PAD];

  const int b = blockIdx.z % B;
  const int split = blockIdx.z / B;
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;
  const long long KK = (long long)Cd * nl;
  // interleaved (re, im) operands
  const T* xb = X + 2 * (long long)ix[b] * n * Cc * nl;
  const T* yb = Y + 2 * (long long)iy[b] * m * KK;
  const T* cb = Ct + (long long)ic[b] * Cd * Cc * nl;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  T acc_re[4][4], acc_im[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc_re[r][s] = acc_im[r][s] = T(0);

  // this block's chunks: KC consecutive l of one d each
  const int ncl = (nl + KC - 1) / KC;
  const int q1 = min((split + 1) * cps, Cd * ncl);
  for (int q = split * cps; q < q1; ++q) {
    const int d = q / ncl;
    const int l0 = (q - d * ncl) * KC;
    // stage this chunk of T = X C and of Y; kk fastest, so a half-warp
    // reads 16 consecutive l of one row
    for (int e = tid; e < TILE * KC; e += THREADS) {
      const int kk = e % KC, r = e / KC;
      const int l = l0 + kk;
      T yr = T(0), yi = T(0), tr = T(0), ti = T(0);
      if (l < nl) {
        const int j = j0 + r, i = i0 + r;
        if (j < m) {
          const T* yp = yb + 2 * ((long long)j * KK + (long long)d * nl + l);
          yr = yp[0];
          yi = yp[1];
        }
        if (i < n) {
          const T* xp = xb + 2 * ((long long)i * Cc * nl + l);
          const T* cp = cb + (long long)d * Cc * nl + l;
          for (int c = 0; c < Cc; ++c) {
            const T cv = cp[(long long)c * nl];
            tr += xp[2 * (long long)c * nl] * cv;
            ti += xp[2 * (long long)c * nl + 1] * cv;
          }
        }
      }
      t_re[kk][r] = tr;
      t_im[kk][r] = ti;
      y_re[kk][r] = yr;
      y_im[kk][r] = yi;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      T ar[4], ai[4], br[4], bi[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ar[r] = t_re[kk][ty + 16 * r];
        ai[r] = t_im[kk][ty + 16 * r];
        br[r] = y_re[kk][tx + 16 * r];
        bi[r] = y_im[kk][tx + 16 * r];
      }
      // T conj(Y)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          acc_re[r][s] += ar[r] * br[s] + ai[r] * bi[s];
          acc_im[r][s] += ai[r] * br[s] - ar[r] * bi[s];
        }
    }
    __syncthreads();
  }

  // out is (B, n, m), or the partial tiles (nsplit, B, n, m)
  T* ob = out + 2 * ((long long)split * B + b) * n * m;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= n) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = j0 + tx + 16 * s;
      if (j >= m) continue;
      T* op = ob + 2 * ((long long)i * m + j);
      op[0] = acc_re[r][s];
      op[1] = acc_im[r][s];
    }
  }
}

// out[e] = sum over the splits of part[s][e], in the order of s
template <typename T>
__global__ void sandwich_reduce(const T* __restrict__ part, T* __restrict__ out,
                                long long count, int nsplit) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  T acc = T(0);
  for (int s = 0; s < nsplit; ++s) acc += part[(long long)s * count + e];
  out[e] = acc;
}

template <typename T>
int launch(const void* X, const void* Y, const void* Ct, void* out, void* part,
           const void* ix, const void* iy, const void* ic, int B, int n, int m, int Cc,
           int Cd, int nl, int nsplit, int cps, cudaStream_t stream) {
  if (B <= 0 || n <= 0 || m <= 0) return 0;
  const int nch = Cd * ((nl + KC - 1) / KC);
  // the plan must cover every chunk, and a split launch needs its scratch
  if (nsplit < 1 || cps < 1 || (long long)nsplit * cps < nch || (nsplit > 1 && !part) ||
      (long long)B * nsplit > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE, B * nsplit);
  sandwich_kernel<T><<<grid, THREADS, 0, stream>>>(
      (const T*)X, (const T*)Y, (const T*)Ct, (T*)(nsplit > 1 ? part : out), (const int*)ix,
      (const int*)iy, (const int*)ic, B, n, m, Cc, Cd, nl, cps);
  int status = (int)cudaGetLastError();
  if (status != 0 || nsplit == 1) return status;
  const long long count = 2LL * B * n * m;
  sandwich_reduce<T><<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
      (const T*)part, (T*)out, count, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// X (Nx, n, Cc, nl), Y (Ny, m, Cd, nl) complex (interleaved), Ct (Nc, Cd, Cc,
// nl) real, out (B, n, m) complex; ix, iy, ic (B,) int32 pick each batch
// item's operands.  The Cd * ceil(nl / 16) chunks go to nsplit blocks per
// tile, cps chunks each; part (nsplit, B, n, m) complex holds their partial
// tiles when nsplit > 1 (else it may be null).
int sandwich_c64(const void* X, const void* Y, const void* Ct, void* out, void* part,
                 const void* ix, const void* iy, const void* ic, int B, int n, int m, int Cc,
                 int Cd, int nl, int nsplit, int cps, void* stream) {
  return launch<float>(X, Y, Ct, out, part, ix, iy, ic, B, n, m, Cc, Cd, nl, nsplit, cps,
                       (cudaStream_t)stream);
}

int sandwich_c128(const void* X, const void* Y, const void* Ct, void* out, void* part,
                  const void* ix, const void* iy, const void* ic, int B, int n, int m, int Cc,
                  int Cd, int nl, int nsplit, int cps, void* stream) {
  return launch<double>(X, Y, Ct, out, part, ix, iy, ic, B, n, m, Cc, Cd, nl, nsplit, cps,
                        (cudaStream_t)stream);
}

}  // extern "C"
