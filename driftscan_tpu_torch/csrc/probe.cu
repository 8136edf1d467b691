// The two runtime probes of scratch/pallas_probe.py, written for Hopper.
//
// probe_double replaces the Pallas kernel `double` (pallas_probe.py:56):
// o = 2 x over a float32 array that the TPU kernel holds whole in VMEM.
// Here a grid-stride loop: each thread doubles every (gridDim * blockDim)-th
// element, so any size runs on a fixed grid.  Bound by memory bandwidth
// (8 bytes moved per element); at the probe's 4 MB it runs from L2.
//
// probe_mm replaces the Pallas kernel `mm` (pallas_probe.py:83): the tiled
// C = A B of float32 or bfloat16 inputs with float32 accumulation and a
// float32 result, which the TPU kernel computes as (256, K) x (K, 256) VMEM
// blocks on the MXU.  Here a block owns a 64 x 64 tile of C and walks K in
// chunks of 16: it stages A's (64, 16) and B's (16, 64) chunks in shared
// memory as float32 (bfloat16 is widened exactly on load) and every thread
// accumulates a 4 x 4 patch in registers with float32 FMAs on the CUDA
// cores.  Bound by float32 FMA throughput on the CUDA cores (no tensor cores; the
// wgmma/TMA pipeline is later work), 2 M N K flops.
//
// Row-major, contiguous A (M, K), B (K, N), C (M, N); ragged edges are
// masked.  Plain versions: driftscan_tpu_torch.ops.probe.double_ref and
// mm_ref.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__global__ void double_kernel(const float* __restrict__ x, float* __restrict__ o,
                              long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    o[i] = x[i] * 2.0f;
}

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;  // 16 x 16, 4 x 4 outputs each

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
mm_kernel(const T* __restrict__ A, const T* __restrict__ B, float* __restrict__ C,
          int M, int N, int K) {
  __shared__ float as[BK][BM + 4];  // A chunk, transposed: as[k][m]
  __shared__ float bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK;
      const int c = e % BK;
      const int gm = m0 + r;
      const int gk = k0 + c;
      as[c][r] = (gm < M && gk < K) ? widen(A[(size_t)gm * K + gk]) : 0.0f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN;
      const int c = e % BN;
      const int gk = k0 + r;
      const int gn = n0 + c;
      bs[r][c] = (gk < K && gn < N) ? widen(B[(size_t)gk * N + gn]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) C[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

template <typename T>
int run_mm(const void* A, const void* B, void* C, int M, int N, int K,
           cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(A),
                                             static_cast<const T*>(B),
                                             static_cast<float*>(C), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int probe_double_f32(const void* x, void* o, long long n, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  double_kernel<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n);
  return (int)cudaGetLastError();
}

int probe_mm_f32(const void* A, const void* B, void* C, int M, int N, int K,
                 void* stream) {
  return run_mm<float>(A, B, C, M, N, K, (cudaStream_t)stream);
}

int probe_mm_bf16(const void* A, const void* B, void* C, int M, int N, int K,
                  void* stream) {
  return run_mm<__nv_bfloat16>(A, B, C, M, N, K, (cudaStream_t)stream);
}

}  // extern "C"
