// K9: the compacted signal Gram S = (B L)(B L)^H of the KL pencil.
//
// Replaces the JAX program driftscan_tpu/ops/fpencil.py:beam_factor_compact
// (its lax.scan over l-chunks of per-chunk Grams; the shifted Cholesky that
// follows stays with torch.linalg).  Per batch element z (an m-mode):
//
//   A[(f, a), (l, k)] = sum_p B[z, f, a, p, l] L[l, p, f, k]
//   S[z, i, j]        = sum_{(l, k)} A[i, (l, k)] conj(A[j, (l, k)])
//
// B (M, F, S, npol, nl) complex, L (nl, npol, F, K) real, S (M, F*S, F*S)
// complex, accumulated in the input precision (float32 complex on the
// card's path).  The (F*S, nl*K) factor A is never written to device
// memory: gram_tile.cuh forms each 16-column chunk of A's rows in shared
// memory and accumulates the 64 x 64 output tile in registers.
//
// What bounds it on an H100: float32 issue on the CUDA cores (no tensor
// cores: 8 flops a complex multiply-add, (F*S)^2 nl K of them per m);
// the inputs (B ~0.3 MB and L ~60 KB per m at the bench's shapes) are
// L2-resident and re-read per tile.
//
// Plain version: driftscan_tpu_torch.ops.fpencil.signal_gram_ref.

#include "gram_tile.cuh"

namespace {

using gram::cpx;

template <typename T>
struct SignalRows {
  const cpx<T>* B;
  const T* L;
  int F, S, npol, nl, K;

  __device__ cpx<T> operator()(int z, int row, int col) const {
    const int f = row / S;
    const int a = row - f * S;
    const int l = col / K;
    const int k = col - l * K;
    const cpx<T>* b = B + (((size_t)z * F + f) * S + a) * npol * nl + l;
    const T* lp = L + ((size_t)l * npol * F + f) * K + k;
    cpx<T> acc{(T)0, (T)0};
    for (int p = 0; p < npol; ++p) {
      const cpx<T> bv = b[(size_t)p * nl];
      const T lv = lp[(size_t)p * F * K];
      acc.re += bv.re * lv;
      acc.im += bv.im * lv;
    }
    return acc;
  }
};

template <typename T>
int run(const void* B, const void* L, void* out, int M, int F, int S, int npol,
        int nl, int K, cudaStream_t stream) {
  SignalRows<T> rows{static_cast<const cpx<T>*>(B), static_cast<const T*>(L),
                     F, S, npol, nl, K};
  return gram::launch_gram<T>(rows, out, F * S, nl * K, M, stream);
}

}  // namespace

extern "C" {

int signal_gram_c64(const void* B, const void* L, void* out, int M, int F,
                    int S, int npol, int nl, int K, void* stream) {
  return run<float>(B, L, out, M, F, S, npol, nl, K, (cudaStream_t)stream);
}

int signal_gram_c128(const void* B, const void* L, void* out, int M, int F,
                     int S, int npol, int nl, int K, void* stream) {
  return run<double>(B, L, out, M, F, S, npol, nl, K, (cudaStream_t)stream);
}

}  // extern "C"
