// K13: the per-band projected covariances of the fused Fisher pass.
//
// Replaces the l-chunk scan of the JAX program
// driftscan_tpu/parallel/mstep.py:fisher_step_split (mstep.py:477-510).
// Per m-mode and band b, with the retained KL modes V (k, F, S), the
// temperature beam rows B_T (F, S, nl) and the band factors L_b (nlp, F, Kb):
//
//   G[i, f, l]     = sum_s V[i, f, s] B_T[f, s, l]        (fisher_g_kernel)
//   Y_b[i, (l, K)] = sum_f G[i, f, l] L_b[l, f, K]
//   C_b[i, j]      = sum_{(l, K)} Y_b[i, (l, K)] conj(Y_b[j, (l, K)])
//
// G (k, F, nlp) is written once per m (zero for l >= nl); Y is never
// written to device memory: gram_tile.cuh forms each 16-column chunk of
// Y_b's rows in shared memory and accumulates C_b tile by tile in
// registers, for every band.  The F_ab contraction that follows is a small
// torch product.
//
// What bounds it on an H100: float32 issue on the CUDA cores (8 flops a
// complex multiply-add, nb k^2 nlp Kb of them per m for the Gram, F more
// per Y element in the tile builds); G and L_b are L2-resident.
//
// Plain version: driftscan_tpu_torch.parallel.mstep.fisher_cov_ref.

#include "gram_tile.cuh"

namespace {

using gram::cpx;

template <typename T>
__global__ void fisher_g_kernel(const cpx<T>* __restrict__ V,
                                const cpx<T>* __restrict__ BT,
                                cpx<T>* __restrict__ G, int k, int F, int S,
                                int nl, int nlp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cpx<T>* v_s = reinterpret_cast<cpx<T>*>(smem_raw);  // [S]
  const int row = blockIdx.x;  // (i, f)
  const int m = blockIdx.y;
  const int i = row / F;
  const int f = row - i * F;
  const cpx<T>* vrow = V + (((size_t)m * k + i) * F + f) * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) v_s[s] = vrow[s];
  __syncthreads();
  const cpx<T>* bt = BT + ((size_t)m * F + f) * S * nl;
  cpx<T>* g = G + (((size_t)m * k + i) * F + f) * nlp;
  for (int l = threadIdx.x; l < nlp; l += blockDim.x) {
    cpx<T> acc{(T)0, (T)0};
    if (l < nl) {
      for (int s = 0; s < S; ++s) {
        const cpx<T> a = v_s[s];
        const cpx<T> b = bt[(size_t)s * nl + l];
        acc.re += a.re * b.re;
        acc.re -= a.im * b.im;
        acc.im += a.re * b.im;
        acc.im += a.im * b.re;
      }
    }
    g[l] = acc;
  }
}

template <typename T>
struct BandRows {
  const cpx<T>* G;
  const T* Lb;
  int k, F, nlp, Kb, nb;

  __device__ cpx<T> operator()(int z, int row, int col) const {
    const int m = z / nb;
    const int band = z - m * nb;
    const int l = col / Kb;
    const int kk = col - l * Kb;
    const cpx<T>* g = G + ((size_t)m * k + row) * F * nlp + l;
    const T* lp = Lb + ((size_t)band * nlp + l) * F * Kb + kk;
    cpx<T> acc{(T)0, (T)0};
    for (int f = 0; f < F; ++f) {
      const cpx<T> gv = g[(size_t)f * nlp];
      const T lv = lp[(size_t)f * Kb];
      acc.re += gv.re * lv;
      acc.im += gv.im * lv;
    }
    return acc;
  }
};

template <typename T>
int run(const void* V, const void* BT, const void* Lb, void* G, void* C, int M,
        int k, int F, int S, int nl, int nlp, int nb, int Kb,
        cudaStream_t stream) {
  dim3 ggrid(k * F, M);
  fisher_g_kernel<T><<<ggrid, 256, sizeof(cpx<T>) * S, stream>>>(
      static_cast<const cpx<T>*>(V), static_cast<const cpx<T>*>(BT),
      static_cast<cpx<T>*>(G), k, F, S, nl, nlp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  BandRows<T> rows{static_cast<const cpx<T>*>(G), static_cast<const T*>(Lb),
                   k, F, nlp, Kb, nb};
  return gram::launch_gram<T>(rows, C, k, nlp * Kb, M * nb, stream);
}

}  // namespace

extern "C" {

int fisher_cov_c64(const void* V, const void* BT, const void* Lb, void* G,
                   void* C, int M, int k, int F, int S, int nl, int nlp, int nb,
                   int Kb, void* stream) {
  return run<float>(V, BT, Lb, G, C, M, k, F, S, nl, nlp, nb, Kb,
                    (cudaStream_t)stream);
}

int fisher_cov_c128(const void* V, const void* BT, const void* Lb, void* G,
                    void* C, int M, int k, int F, int S, int nl, int nlp,
                    int nb, int Kb, void* stream) {
  return run<double>(V, BT, Lb, G, C, M, k, F, S, nl, nlp, nb, Kb,
                     (cudaStream_t)stream);
}

}  // extern "C"
