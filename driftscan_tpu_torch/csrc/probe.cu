// The two runtime probes of scratch/pallas_probe.py, written for Hopper.
//
// probe_double replaces the Pallas kernel `double` (pallas_probe.py:56):
// o = 2 x over a float32 array that the TPU kernel holds whole in VMEM.
// Bound by bytes: 8 a element, read once and written once.  Each thread
// moves 16 bytes a load and a store (float4); a scalar head runs up to the
// first 16-byte boundary and a scalar tail past the last multiple of 4.
// The wrapper gives the output the input's alignment modulo 16, so one
// index serves both.  The grid covers the array, a float4 a thread:
// blocks that retire and make room for the next keep more of HBM's
// bandwidth busy than a resident grid of a few blocks an SM striding over
// the array, which reached 0.84-0.85 of the bound at 8192^2 against
// 0.90 on an H100 (experiments/double_grids.py, the launch's max_blocks).
//
// probe_mm replaces the Pallas kernel `mm` (pallas_probe.py:83): C = A B
// of float32 or bfloat16 (M, K) and (K, N) row-major inputs, float32
// accumulation and a float32 (M, N) result, which the TPU kernel computes
// as (256, K) x (K, 256) VMEM blocks on the MXU.  A block of 384 threads
// owns a tile of 128 rows by NW columns: one producer warpgroup fills a
// ring of shared-memory stages (tma_ring.cuh) and two consumer warpgroups
// multiply, 64 rows each, on the tensor cores with wgmma, their
// accumulators in registers.  The tile leaves through shared memory, in
// row-contiguous 16-byte stores masked at the ragged edge: stored
// straight from the accumulator fragments (two floats a lane) it cost
// more than the main loop at small K.  setmaxnreg gives the producers 40
// registers and the consumers 232.
//
//   * bfloat16: bound by the tensor cores' 989 TFLOP/s at large shapes and
//     by the bytes at 1024^3, where the 64-wide tiles' wgmma operand reads
//     and TMA writes run into shared memory's bandwidth instead (PERF.md).
//     A producer thread loads each stage with TMA
//     (A's 128 x 64 box, B's 64 x 64 boxes, 128-byte swizzle) onto the
//     stage's full barrier; the consumers run wgmma m64nNWk16 from shared
//     memory, A K-major and B MN-major through the transpose-B immediate,
//     keep one stage's products in flight and hand each stage back on its
//     empty barrier.
//   * float32: 3xTF32, a b = a_b b_b + a_b b_s + a_s b_b with x_b = rna(x)
//     and x_s = rna(x - x_b) (mma_tiles.cuh), bound by 495/3 TFLOP/s.
//     wgmma takes 32-bit operands from shared memory only K-major, and B
//     is MN-major, so the block computes a tile of C^T = B^T A^T: B^T is
//     the register operand, loaded by each consumer from the raw TMA tile
//     of B and split in registers; A^T's K-major rows are A's own, so
//     three producer warps split A's TMA tile in place into its big plane
//     and a small plane beside it (the same swizzled positions) and
//     release the stage on its ready barrier.  Each 32-deep stage's twelve
//     products start from a zero accumulator and are added to the float32
//     totals on the CUDA cores: the tensor cores add with truncation.
//   * The tile width NW (64, 128 or 256 for bfloat16, 64 or 128 for
//     float32) follows the SM count: ops/probe.py's mm_plan takes the width
//     whose waves of blocks finish first.  At 1024^3 on 132 SMs that is 64:
//     128 blocks, where 128-wide tiles would leave 68 SMs idle.
//   * TMA needs 16-byte aligned pointers and row strides.  Where they are
//     not, the same kernel runs its staged route: all 128 producer threads
//     load each stage with plain loads (zeros past the edges) into the same
//     swizzled layout and split it as the TMA route does.
//
// Plain versions: driftscan_tpu_torch.ops.probe.double_ref and mm_ref.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "tma_ring.cuh"

namespace {

using namespace ring;

// ------------------------------------------------------------------ double

constexpr int DOUBLE_THREADS = 256;

__global__ void __launch_bounds__(DOUBLE_THREADS)
double_kernel(const float* __restrict__ x, float* __restrict__ o, long long n, int head) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (tid < head) o[tid] = x[tid] * 2.0f;
  const long long nv = (n - head) >> 2;
  const float4* __restrict__ xv = reinterpret_cast<const float4*>(x + head);
  float4* __restrict__ ov = reinterpret_cast<float4*>(o + head);
  for (long long i = tid; i < nv; i += stride) {
    const float4 v = xv[i];
    ov[i] = make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
  }
  const long long t = head + (nv << 2) + tid;
  if (t < n) o[t] = x[t] * 2.0f;
}

// ---------------------------------------------------------------------- mm

constexpr int ROWS = 128;     // tile rows: two consumer warpgroups of 64
constexpr int THREADS = 384;  // two consumer warpgroups, one producer warpgroup
constexpr int CONSUMER_WARPS = 8;
constexpr int SPLITTERS = 96;  // producer warps 1-3 split float32 stages

// One stage of the ring, by dtype and tile width NW.
//   bfloat16 (C = A B; tile rows m, columns n): A (128 m x 64 k), then B
//     (64 k x NW n) as NW / 64 slabs of 64 n, 8 KB apart.
//   float32 (C^T = B^T A^T; tile rows n, columns m): B raw (32 k x 128 n)
//     as 4 slabs of 32 n, 4 KB apart; A's big plane (NW m x 32 k, split in
//     place); A's small plane.
// Every row is 128 bytes, 128-byte swizzled, every tile 1024-aligned.
template <bool F32, int NW>
struct Stage {
  static constexpr int BK = F32 ? 32 : 64;  // K a stage
  static constexpr int ROW_BYTES = ROWS * 128;  // the row operand's tile
  static constexpr int COL_BYTES = NW * 128;  // one column-operand plane
  static constexpr int SLAB = F32 ? 4096 : 8192;  // bytes between B's slabs
  static constexpr int SLAB_N = F32 ? 32 : 64;    // n values a slab
  static constexpr int BYTES = ROW_BYTES + (F32 ? 2 : 1) * COL_BYTES;
  static constexpr int TX = ROW_BYTES + COL_BYTES;  // bytes a stage's TMA loads bring
  static constexpr int COUNT = 196608 / BYTES < 6 ? 196608 / BYTES : 6;
  static constexpr int SMEM = COUNT * BYTES + 1024 + 3 * COUNT * 8;
};

// The staged route: all 128 producer threads load one stage (K from k0)
// with plain loads, zeros past the edges, into the TMA route's layout
// (float32: A already split into its planes).
template <bool F32, int NW>
__device__ __forceinline__ void stage_plain(unsigned char* st, const void* A, const void* B,
                                            int M, int N, int K, int r0, int c0, int k0,
                                            int p) {
  using S = Stage<F32, NW>;
  if constexpr (F32) {
    const float* a = static_cast<const float*>(A);
    const float* b = static_cast<const float*>(B);
    for (int e = p; e < S::BK * ROWS; e += 128) {  // B raw: (k, n), n fastest
      const int k = e / ROWS, n = e % ROWS;
      const int gk = k0 + k, gn = r0 + n;
      const float v = (gk < K && gn < N) ? b[(size_t)gk * N + gn] : 0.f;
      *reinterpret_cast<float*>(st + (n / 32) * S::SLAB + sw128(k * 128 + (n % 32) * 4)) = v;
    }
    for (int e = p; e < NW * S::BK; e += 128) {  // A planes: (m, k), k fastest
      const int m = e / S::BK, k = e % S::BK;
      const int gm = c0 + m, gk = k0 + k;
      const float v = (gm < M && gk < K) ? a[(size_t)gm * K + gk] : 0.f;
      uint32_t big, small;
      mma::tf32_split(v, big, small);
      const uint32_t o = S::ROW_BYTES + sw128(m * 128 + k * 4);
      *reinterpret_cast<uint32_t*>(st + o) = big;
      *reinterpret_cast<uint32_t*>(st + o + S::COL_BYTES) = small;
    }
  } else {
    const uint16_t* a = static_cast<const uint16_t*>(A);
    const uint16_t* b = static_cast<const uint16_t*>(B);
    for (int e = p; e < ROWS * S::BK; e += 128) {  // A: (m, k), k fastest
      const int m = e / S::BK, k = e % S::BK;
      const int gm = r0 + m, gk = k0 + k;
      const uint16_t v = (gm < M && gk < K) ? a[(size_t)gm * K + gk] : (uint16_t)0;
      *reinterpret_cast<uint16_t*>(st + sw128(m * 128 + k * 2)) = v;
    }
    for (int e = p; e < S::BK * NW; e += 128) {  // B: (k, n), n fastest
      const int k = e / NW, n = e % NW;
      const int gk = k0 + k, gn = c0 + n;
      const uint16_t v = (gk < K && gn < N) ? b[(size_t)gk * N + gn] : (uint16_t)0;
      *reinterpret_cast<uint16_t*>(st + S::ROW_BYTES + (n / 64) * S::SLAB +
                                   sw128(k * 128 + (n % 64) * 2)) = v;
    }
  }
}

template <int NW>
__device__ __forceinline__ void wgmma_bf16(float (&d)[NW / 2], uint64_t da, uint64_t db) {
  if constexpr (NW == 64) wgmma_bf16_n64(d, da, db, 1);
  else if constexpr (NW == 128) wgmma_bf16_n128(d, da, db, 1);
  else wgmma_bf16_n256(d, da, db, 1);
}

// The two consumer warpgroups (barrier 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The consumers' epilogue: the ROWS_T x COLS_T tile (leading dimension LD
// floats) at C's row row0, column col0, one row a few lanes wide, 16 bytes
// a lane where C's rows allow (N a multiple of 4: C is a fresh, aligned
// allocation), masked at the edges.
template <int ROWS_T, int COLS_T, int LD>
__device__ __forceinline__ void store_rows(const float* tile, float* C, int row0, int col0,
                                           int M, int N, int tid) {
  constexpr int Q = COLS_T / 4;
  const bool vec = (N & 3) == 0;
  for (int e = tid; e < ROWS_T * Q; e += 256) {
    const int r = e / Q;
    const int c = (e % Q) * 4;
    const int gr = row0 + r;
    const int gc = col0 + c;
    if (gr >= M) continue;
    const float4 v = *reinterpret_cast<const float4*>(tile + r * LD + c);
    float* dst = C + (size_t)gr * N + gc;
    if (vec && gc + 4 <= N) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      if (gc < N) dst[0] = v.x;
      if (gc + 1 < N) dst[1] = v.y;
      if (gc + 2 < N) dst[2] = v.z;
      if (gc + 3 < N) dst[3] = v.w;
    }
  }
}

template <bool F32, int NW, bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
mm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
          const void* __restrict__ A, const void* __restrict__ B, float* __restrict__ C, int M,
          int N, int K) {
  using S = Stage<F32, NW>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::COUNT * S::BYTES);
  uint64_t* ready = full + S::COUNT;  // float32 and the staged route: stage ready to multiply
  uint64_t* empty = ready + S::COUNT;
  // bfloat16 over TMA multiplies what the TMA brings
  uint64_t* consume = (TMA && !F32) ? full : ready;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * ROWS;  // bfloat16: m; float32: n
  const int c0 = blockIdx.x * NW;    // bfloat16: n; float32: m
  const int nk = (K + S::BK - 1) / S::BK;

  if (tid == 0) {
    for (int s = 0; s < S::COUNT; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], TMA ? SPLITTERS : 128);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 2 * 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int p = tid - 2 * 128;
    if constexpr (TMA) {
      if (p == 0) {
        prefetch_map(&map_a);
        prefetch_map(&map_b);
        for (int i = 0; i < nk; ++i) {
          const int s = i % S::COUNT;
          if (i >= S::COUNT) mbar_wait(&empty[s], ((i / S::COUNT) - 1) & 1);
          unsigned char* st = smem + s * S::BYTES;
          const int k0 = i * S::BK;
          mbar_expect_tx(&full[s], S::TX);
          if constexpr (F32) {
#pragma unroll
            for (int j = 0; j < ROWS / S::SLAB_N; ++j)
              tma_load_2d(st + j * S::SLAB, &map_b, &full[s], r0 + j * S::SLAB_N, k0);
            tma_load_2d(st + S::ROW_BYTES, &map_a, &full[s], k0, c0);
          } else {
            tma_load_2d(st, &map_a, &full[s], k0, r0);
#pragma unroll
            for (int j = 0; j < NW / S::SLAB_N; ++j)
              tma_load_2d(st + S::ROW_BYTES + j * S::SLAB, &map_b, &full[s],
                          c0 + j * S::SLAB_N, k0);
          }
        }
      } else if (F32 && p >= 32) {
        // split A's landed tile in place into its big plane, and its small
        // plane beside it
        const int q = p - 32;
        for (int i = 0; i < nk; ++i) {
          const int s = i % S::COUNT;
          mbar_wait(&full[s], (i / S::COUNT) & 1);
          uint4* big = reinterpret_cast<uint4*>(smem + s * S::BYTES + S::ROW_BYTES);
          uint4* small = big + S::COL_BYTES / 16;
          for (int e = q; e < S::COL_BYTES / 16; e += SPLITTERS) {
            uint4 v = big[e], w;
            mma::tf32_split(__uint_as_float(v.x), v.x, w.x);
            mma::tf32_split(__uint_as_float(v.y), v.y, w.y);
            mma::tf32_split(__uint_as_float(v.z), v.z, w.z);
            mma::tf32_split(__uint_as_float(v.w), v.w, w.w);
            big[e] = v;
            small[e] = w;
          }
          fence_async_smem();
          mbar_arrive(&ready[s]);
        }
      }
    } else {
      for (int i = 0; i < nk; ++i) {
        const int s = i % S::COUNT;
        if (i >= S::COUNT) mbar_wait(&empty[s], ((i / S::COUNT) - 1) & 1);
        stage_plain<F32, NW>(smem + s * S::BYTES, A, B, M, N, K, r0, c0, i * S::BK, p);
        fence_async_smem();
        mbar_arrive(&ready[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid >> 7;
  const int w = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  float acc[NW / 2];
#pragma unroll
  for (int j = 0; j < NW / 2; ++j) acc[j] = 0.f;

  if constexpr (F32) {
    // this thread's B^T fragment: tile rows (n) 64 wg + 16 w + g (+ 8) at
    // k = t (+ 4) of each k8 step; byte offsets in the raw B tile, the k8
    // step kk 1024 bytes further (8 rows: the same swizzle phase)
    const int slab = 2 * wg + (w >> 1);
    const uint32_t cb = (16 * (w & 1) + g) * 4;
    uint32_t off[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      off[q] = slab * S::SLAB + sw128((t + 4 * (q >> 1)) * 128 + cb + 32 * (q & 1));
    float tot[NW / 2];
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) tot[j] = 0.f;
    for (int i = 0; i < nk; ++i) {
      const int s = i % S::COUNT;
      mbar_wait(&consume[s], (i / S::COUNT) & 1);
      const unsigned char* st = smem + s * S::BYTES;
      // the stage's B^T fragments, split into big and small
      uint32_t fb[4][4], fs[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma::tf32_split(*reinterpret_cast<const float*>(st + off[q] + kk * 1024), fb[kk][q],
                          fs[kk][q]);
      const uint64_t dbig = desc_sw128(st + S::ROW_BYTES, 0, 1024);
      const uint64_t dsmall = desc_sw128(st + S::ROW_BYTES + S::COL_BYTES, 0, 1024);
      // the stage's twelve products from a zero accumulator; nothing
      // writes a register while they are in flight
      fence_operand(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tf32<NW>(acc, fb[kk], dbig + 2 * kk, kk > 0);
        wgmma_tf32<NW>(acc, fb[kk], dsmall + 2 * kk, 1);
        wgmma_tf32<NW>(acc, fs[kk], dbig + 2 * kk, 1);
      }
      wg_commit();
      wg_wait<0>();
      fence_operand(acc);
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int j = 0; j < NW / 2; ++j) tot[j] += acc[j];
    }
    // tile row n, column m holds C[m, n]: through shared memory as
    // tile[m][n], then rows of C
    constexpr int LD = ROWS + 4;
    static_assert(NW * LD * 4 <= S::COUNT * S::BYTES, "epilogue tile fits the ring");
    float* tile = reinterpret_cast<float*>(smem);
    consumers_sync();
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) {
      const int n = 64 * wg + 16 * w + g + 8 * ((j >> 1) & 1);
      const int m = 8 * (j >> 2) + 2 * t + (j & 1);
      tile[m * LD + n] = tot[j];
    }
    consumers_sync();
    store_rows<NW, ROWS, LD>(tile, C, c0, r0, M, N, tid);
  } else {
    for (int i = 0; i < nk; ++i) {
      const int s = i % S::COUNT;
      mbar_wait(&consume[s], (i / S::COUNT) & 1);
      const unsigned char* st = smem + s * S::BYTES;
      const uint64_t da = desc_sw128(st + wg * 64 * 128, 0, 1024);
      const uint64_t db = desc_sw128(st + S::ROW_BYTES, S::SLAB, 1024);
      fence_operand(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_bf16<NW>(acc, da + 2 * kk, db + 128 * kk);
      wg_commit();
      // the previous stage's products are done: hand its buffers back
      wg_wait<1>();
      fence_operand(acc);
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % S::COUNT]);
    }
    wg_wait<0>();
    fence_operand(acc);
    // through shared memory as tile[m][n], then rows of C
    constexpr int LD = NW + 8;
    static_assert(ROWS * LD * 4 <= S::COUNT * S::BYTES, "epilogue tile fits the ring");
    float* tile = reinterpret_cast<float*>(smem);
    consumers_sync();
#pragma unroll
    for (int j = 0; j < NW / 2; j += 2) {
      const int m = 64 * wg + 16 * w + g + 8 * ((j >> 1) & 1);
      const int n = 8 * (j >> 2) + 2 * t;
      *reinterpret_cast<float2*>(tile + m * LD + n) = make_float2(acc[j], acc[j + 1]);
    }
    consumers_sync();
    store_rows<ROWS, NW, LD>(tile, C, r0, c0, M, N, tid);
  }
}

template <bool F32, int NW, bool TMA>
int launch_mm(const void* A, const void* B, void* C, int M, int N, int K, cudaStream_t stream) {
  using S = Stage<F32, NW>;
  CUtensorMap map_a{}, map_b{};
  if (TMA) {
    const CUtensorMapDataType type =
        F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const int es = F32 ? 4 : 2;
    // A: boxes of (the tile's A rows) x BK; B: BK x one slab
    int e = make_map(&map_a, type, es, A, M, K, K, F32 ? NW : ROWS, S::BK,
                     CU_TENSOR_MAP_SWIZZLE_128B);
    if (!e)
      e = make_map(&map_b, type, es, B, K, N, N, S::BK, S::SLAB_N, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e) return e;
  }
  constexpr auto kernel = mm_kernel<F32, NW, TMA>;
  // setmaxnreg.inc waits for registers the block does not hold if the
  // build gave it fewer than the split needs: refuse instead of hanging
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes fa;
    const cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return (int)e;
    regs = fa.numRegs;
  }
  if (regs * THREADS < 40 * 128 + 232 * 256) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t e = allow_smem<kernel>(S::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int rows = F32 ? N : M;
  const int cols = F32 ? M : N;
  const dim3 grid((cols + NW - 1) / NW, (rows + ROWS - 1) / ROWS);
  kernel<<<grid, THREADS, S::SMEM, stream>>>(map_a, map_b, A, B, static_cast<float*>(C), M, N,
                                             K);
  return (int)cudaGetLastError();
}

template <bool F32, bool TMA>
int run_mm(const void* A, const void* B, void* C, int M, int N, int K, int nw,
           cudaStream_t stream) {
  if (nw == 64) return launch_mm<F32, 64, TMA>(A, B, C, M, N, K, stream);
  if (nw == 128) return launch_mm<F32, 128, TMA>(A, B, C, M, N, K, stream);
  if constexpr (!F32)
    if (nw == 256) return launch_mm<F32, 256, TMA>(A, B, C, M, N, K, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// o = 2 x over n floats; o must share x's address modulo 16 (the
// wrapper allocates it so).  max_blocks: 0 for a grid that covers the
// array (a float4 a thread), else at most that many blocks striding over
// it.
int probe_double_f32(const void* x, void* o, long long n, long long max_blocks, void* stream) {
  if (n <= 0) return 0;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if ((xa ^ reinterpret_cast<uintptr_t>(o)) & 15) return (int)cudaErrorMisalignedAddress;
  const long long lead = (long long)(((16 - (xa & 15)) & 15) >> 2);
  const long long head = lead < n ? lead : n;
  const long long vecs = (n - head) / 4 > 4 ? (n - head) / 4 : 4;
  long long blocks = (vecs + DOUBLE_THREADS - 1) / DOUBLE_THREADS;
  if (max_blocks > 0 && blocks > max_blocks) blocks = max_blocks;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  double_kernel<<<(int)blocks, DOUBLE_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n, (int)head);
  return (int)cudaGetLastError();
}

// C = A B, row-major contiguous A (M, K), B (K, N), C (M, N) float32; tma:
// the TMA route (16-byte aligned pointers and row strides), else the
// staged one; nw: the tile width of ops/probe.py's mm_plan.
int probe_mm_f32(const void* A, const void* B, void* C, int M, int N, int K, int tma, int nw,
                 void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return tma ? run_mm<true, true>(A, B, C, M, N, K, nw, st)
             : run_mm<true, false>(A, B, C, M, N, K, nw, st);
}

int probe_mm_bf16(const void* A, const void* B, void* C, int M, int N, int K, int tma, int nw,
                  void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return tma ? run_mm<false, true>(A, B, C, M, N, K, nw, st)
             : run_mm<false, false>(A, B, C, M, N, K, nw, st);
}

}  // extern "C"
