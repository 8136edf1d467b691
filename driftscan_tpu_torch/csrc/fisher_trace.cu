// K15b: the weighted Fisher trace F[m, a, b] = sum_ij w_i w_j C_a[i, j] C_b[j, i].
//
// Replaces the JAX program driftscan_tpu/ops/projections.py:352
// _fisher_trace_native (with the host-side weighting of fisher_trace_block)
// and the tail of driftscan_tpu/parallel/mstep.py:387 fisher_step_split.
// C_a (M, na, k, k) and C_b (M, nb, k, k) complex64 or complex128, w (M, k)
// float32 or float64; F (M, na, nb) complex128, every product and sum in
// float64 whatever the input type.  Plain version:
// driftscan_tpu_torch.ops.projections.fisher_trace_ref.
//
// The JAX program scales C_a by w_i w_j into a new array, transposes C_b
// into another and multiplies the two flattened (bands, k^2) matrices.
// With single-digit band counts no tile of that product fills a tensor-core
// instruction, so this is one pass over the stacks on the CUDA cores:
//
//   * a job is an 8 x 8 (i, j) tile of one m, and each warp walks its own
//     jobs: it stages, with 8- or 16-byte cp.async copies along the
//     matrices' rows, the (i, j) tile of every C_a of its band tile (up to
//     4 bands a side), the mirrored (j, i) tile of every C_b (rows padded
//     to 9, so the transposed read C_b[j, i] is a shared read, not a
//     strided global one) and the 16 weights, into a ring of its own, two
//     or three jobs ahead; each lane adds its two elements' w_i w_j
//     C_a[i, j] C_b[j, i] to all its band pairs' float64 sums in
//     registers.  No block barrier between jobs: the eight warps of a
//     block overlap each other's copies.  Each C is read once for all band
//     pairs (once for every 4 bands of the other side beyond 4);
//   * the jobs of one m go round-robin to the 8 x `split` warps of a
//     thread-block cluster, across its ranks first (split <= 8, cluster
//     rank = blockIdx.x; the planner ops/projections.py fisher_trace_plan
//     sizes it so that M x split blocks fill the card and no rank is idle).  Each block sums
//     its threads' values in a fixed order (a butterfly exchange in each
//     warp that leaves one value a lane, then the warps in order); after a
//     cluster barrier the ranks read each other's sums (distributed shared
//     memory) and add them in rank order.  One launch, no scratch, no
//     atomics: two calls give the same bits;
//   * every path passes one stack as both C_a and C_b.  The wrapper sees
//     that (the same storage, and at most 4 bands) and takes the symmetric
//     form: F_ab = F_ba and the (i, j) and (j, i) terms pair up, so the
//     jobs are the tile pairs I <= J (half the bytes): with the weights
//     w_i w_j on i < j, half that on i = j and nothing for i > j inside a
//     diagonal tile, P_ab = sum w_i w_j C_a[i, j] C_b[j, i] over those
//     gives F_ab = P_ab + P_ba, written to both F_ab and F_ba.
//
// What bounds it on an H100: at large k the bytes and the float64 products
// of the 8 SMs of one cluster (M 1, 4 bands, k 352, complex128: 4 MB of
// upper-triangle tiles and 5 M float64 multiply-adds, ~5 us for those 8
// SMs' float64 units, against 1.2 us for the bytes over the whole card's
// memory rate); at the fused Fisher step's k ~ 52 (M 8) one round trip of
// the copies, the block and cluster sums, and the launch itself, with the
// host path in front of it (checks, the cached ctypes entry, one
// allocation).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mma_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WT = 8;             // job tile edge (TRACE_TILE in ops/projections.py)
constexpr int LD = WT + 1;        // padded row of a staged tile
constexpr int WARPS = 8;          // warps a block (TRACE_WARPS)
constexpr int THREADS = 32 * WARPS;
constexpr int BT = 4;             // bands a side per block (TRACE_BANDS)
constexpr int SLOTS = 2 * BT;     // staged tiles a job: U_a (a < BT), then V_b
constexpr int MAX_SPLIT = 8;      // portable cluster size (TRACE_MAX_SPLIT)
constexpr int NV = 2 * BT * BT;   // float64 sums a thread: (re, im) of BT x BT pairs
constexpr size_t SMEM_MAX = 232448;

template <typename T>
struct cpx {
  T re, im;
};

struct Params {
  int na, nb, k, nt, njobs, split;
  bool sym;
};

// One job's slot in a warp's ring: SLOTS tiles, then the weights w_i of the
// tile's rows and w_j of its columns.
template <typename T, typename W>
struct Stage {
  cpx<T> tile[SLOTS][WT * LD];
  W w[2 * WT];
};

// (I, J) of job t: row-major over nt x nt, or over the upper triangle
// I <= J for the symmetric form (row I starts at job I nt - I (I - 1) / 2:
// the root of that quadratic, corrected by one either way).
__device__ __forceinline__ void job_tile(const Params& p, int t, int& I, int& J) {
  if (!p.sym) {
    I = t / p.nt;
    J = t % p.nt;
    return;
  }
  const double b = 2.0 * p.nt + 1.0;
  I = (int)((b - sqrt(fmax(b * b - 8.0 * t, 0.0))) * 0.5);
  auto start = [&](int r) { return r * p.nt - r * (r - 1) / 2; };
  while (I > 0 && start(I) > t) --I;
  while (start(I + 1) <= t) ++I;
  J = I + (t - start(I));
}

// The next job of a warp: `stride` jobs on, in the same order.
__device__ __forceinline__ void job_advance(const Params& p, int stride, int& I, int& J) {
  J += stride;
  if (p.sym) {
    while (J >= p.nt && I < p.nt) {
      ++I;
      J = J - p.nt + I;
    }
  } else {
    while (J >= p.nt) {
      J -= p.nt;
      ++I;
    }
  }
}

__device__ __forceinline__ void cmac(double& ar, double& ai, double xr, double xi, double yr,
                                     double yi) {
  ar = fma(xr, yr, fma(-xi, yi, ar));
  ai = fma(xr, yi, fma(xi, yr, ai));
}

// One step of a warp's butterfly sum: the lane keeps the upper or lower
// half of its 2 S values (by bit S of its lane) and adds its partner's.
template <int S>
__device__ __forceinline__ void butterfly(double (&acc)[NV], int lane) {
  const bool upper = lane & S;
#pragma unroll
  for (int x = 0; x < S; ++x) {
    const double mine = upper ? acc[x + S] : acc[x];
    const double theirs = __shfl_xor_sync(0xffffffffu, upper ? acc[x] : acc[x + S], S);
    acc[x] = mine + theirs;
  }
}

template <typename T, typename W, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
fisher_trace_kernel(const cpx<T>* __restrict__ ca, const cpx<T>* __restrict__ cb,
                    const W* __restrict__ w, cpx<double>* __restrict__ out, Params p) {
  using St = Stage<T, W>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  St* ring = reinterpret_cast<St*>(smem) + warp * STAGES;
  double* part = reinterpret_cast<double*>(smem + (size_t)WARPS * STAGES * sizeof(St));
  double* red = part + NV;  // the warps' sums

  const int rank = blockIdx.x;
  const long long m = blockIdx.z;
  const int nbt_b = (p.nb + BT - 1) / BT;
  const int A = blockIdx.y / nbt_b, B = blockIdx.y % nbt_b;  // sym: one band tile
  const int a0 = A * BT, b0 = B * BT;
  const int nat = min(BT, p.na - a0), nbt_ = min(BT, p.nb - b0);
  const long long kk = (long long)p.k * p.k;
  const cpx<T>* ma = ca + (m * p.na + a0) * kk;
  const cpx<T>* mb = (p.sym ? ma : cb + (m * p.nb + b0) * kk);
  const W* wm = w + m * p.k;

  // this warp's jobs: g, g + streams, ... of the m's njobs, the streams
  // dealt across the ranks first
  const int streams = p.split * WARPS, g = warp * p.split + rank;
  const int nj = g < p.njobs ? (p.njobs - g + streams - 1) / streams : 0;
  int iI = 0, iJ = 0;  // the next job to stage
  if (nj) job_tile(p, g, iI, iJ);

  // slots: U_a = C_a[I, J] at a, V_b = C_b[J, I] at BT + b (C_b is C_a
  // for one stack)
  auto issue = [&](int t) {
    if (t < nj) {
      St& st = ring[t % STAGES];
      const int i0 = iI * WT, j0 = iJ * WT;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = lane + 32 * h, r = e / WT, c = e % WT;
        const bool in_ij = i0 + r < p.k && j0 + c < p.k;
        const bool in_ji = j0 + r < p.k && i0 + c < p.k;
        const long long at_ij = (long long)(i0 + r) * p.k + (j0 + c);
        const long long at_ji = (long long)(j0 + r) * p.k + (i0 + c);
        for (int a = 0; a < nat; ++a)
          mma::cp_async<sizeof(cpx<T>)>(&st.tile[a][r * LD + c],
                                        in_ij ? ma + a * kk + at_ij : ma, in_ij);
        const int nv = p.sym ? nat : nbt_;
        for (int b = 0; b < nv; ++b)
          mma::cp_async<sizeof(cpx<T>)>(&st.tile[BT + b][r * LD + c],
                                        in_ji ? mb + b * kk + at_ji : mb, in_ji);
      }
      if (lane < 2 * WT) {
        const int idx = (lane < WT ? i0 : j0 - WT) + lane;
        const bool ok = idx < p.k;
        mma::cp_async<sizeof(W)>(&st.w[lane], ok ? wm + idx : wm, ok);
      }
      job_advance(p, streams, iI, iJ);
    }
    mma::cp_async_commit();
  };

  double acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.0;

  // a lane's elements: (r, c) and (r + 4, c) of the tile
  const int er = lane / WT, ec = lane % WT;
  int cI = 0, cJ = 0;  // the job being summed
  if (nj) job_tile(p, g, cI, cJ);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int t = 0; t < nj; ++t) {
    mma::cp_async_wait<STAGES - 2>();
    __syncwarp();
    issue(t + STAGES - 1);
    const St& st = ring[t % STAGES];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = er + 4 * h;
      const int i = cI * WT + r, j = cJ * WT + ec;
      double ww = (double)st.w[r] * (double)st.w[WT + ec];
      if (p.sym) ww *= i < j ? 1.0 : (i == j ? 0.5 : 0.0);
      const int at_ij = r * LD + ec, at_ji = ec * LD + r;

      double xr[BT], xi[BT];
#pragma unroll
      for (int a = 0; a < BT; ++a) {
        xr[a] = xi[a] = 0.0;
        if (a < nat) {
          const cpx<T> u = st.tile[a][at_ij];
          xr[a] = ww * (double)u.re;
          xi[a] = ww * (double)u.im;
        }
      }
      // acc_ab += (w_i w_j C_a[i, j]) C_b[j, i]; for one stack the
      // upper-triangle weights make these the sums P_ab, F_ab = P_ab + P_ba
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        if (b >= nbt_) continue;
        const cpx<T> y = st.tile[BT + b][at_ji];
        const double yr = (double)y.re, yi = (double)y.im;
#pragma unroll
        for (int a = 0; a < BT; ++a)
          cmac(acc[2 * (a * BT + b)], acc[2 * (a * BT + b) + 1], xr[a], xi[a], yr, yi);
      }
    }
    __syncwarp();  // every lane has read this slot before it is staged again
    job_advance(p, streams, cI, cJ);
  }
  mma::cp_async_wait<0>();

  // the block's sums in a fixed order: a butterfly within each warp (at
  // stride s every lane keeps half of its 2 s values and adds its partner's
  // half of them: 31 exchanges leave lane l with the warp's sum of value
  // l), then the warps in order
  auto owned = [&](int pair) { return pair / BT < nat && pair % BT < nbt_; };
  static_assert(NV == 32, "one value a lane after the butterfly");
  butterfly<16>(acc, lane);
  butterfly<8>(acc, lane);
  butterfly<4>(acc, lane);
  butterfly<2>(acc, lane);
  butterfly<1>(acc, lane);
  red[warp * 32 + lane] = acc[0];
  __syncthreads();
  if (tid < NV && owned(tid / 2)) {
    double s = 0.0;
    for (int x = 0; x < WARPS; ++x) s += red[x * 32 + tid];
    part[tid] = s;
  }

  if (p.split == 1) {  // one block an m: its sums are F's (P's for one stack)
    __syncthreads();
    const int a = tid / BT, b = tid % BT;
    if (tid < BT * BT && owned(tid) && !(p.sym && b < a)) {
      const int mirror = b * BT + a;
      const cpx<double> f = p.sym ? cpx<double>{part[2 * tid] + part[2 * mirror],
                                                part[2 * tid + 1] + part[2 * mirror + 1]}
                                  : cpx<double>{part[2 * tid], part[2 * tid + 1]};
      out[(m * p.na + a0 + a) * p.nb + b0 + b] = f;
      if (p.sym) out[(m * p.na + b0 + b) * p.nb + a0 + a] = f;
    }
    return;
  }

  // the cluster's ranks in order; rank r writes the pairs r, r + split, ...
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int pair = rank + p.split * tid;
  const int a = pair / BT, b = pair % BT;
  if (pair < BT * BT && owned(pair) && !(p.sym && b < a)) {
    // every rank's value first (the remote reads overlap), then the sum;
    // for one stack F_ab = F_ba = P_ab + P_ba
    const int mirror = b * BT + a;
    double vr[MAX_SPLIT], vi[MAX_SPLIT], ur[MAX_SPLIT], ui[MAX_SPLIT];
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s) {
      vr[s] = vi[s] = ur[s] = ui[s] = 0.0;
      if (s < p.split) {
        const double* rp = cluster.map_shared_rank(part, s);
        vr[s] = rp[2 * pair];
        vi[s] = rp[2 * pair + 1];
        if (p.sym) {
          ur[s] = rp[2 * mirror];
          ui[s] = rp[2 * mirror + 1];
        }
      }
    }
    double sr = 0.0, si = 0.0, tr = 0.0, ti = 0.0;
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s) {
      if (s < p.split) {
        sr += vr[s];
        si += vi[s];
        tr += ur[s];
        ti += ui[s];
      }
    }
    const cpx<double> f = p.sym ? cpx<double>{sr + tr, si + ti} : cpx<double>{sr, si};
    out[(m * p.na + a0 + a) * p.nb + b0 + b] = f;
    if (p.sym) out[(m * p.na + b0 + b) * p.nb + a0 + a] = f;
  }
  // no block leaves while another still reads its sums
  cluster.sync();
}

template <typename T, typename W, int STAGES>
int launch_ring(const Params& p, const void* ca, const void* cb, const void* w, void* out, int M,
                int pairs, cudaStream_t stream) {
  const size_t smem =
      (size_t)WARPS * STAGES * sizeof(Stage<T, W>) + (NV + 32 * WARPS) * sizeof(double);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = fisher_trace_kernel<T, W, STAGES>;
  // the shared-memory opt-in, once per device (the calls are host-bound)
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= 64 || !smem_set[dev])) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_MAX);
    if (e == cudaSuccess && dev < 64) smem_set[dev] = true;
  }
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.split, pairs, M);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;  // one block an m: no cluster
  e = cudaLaunchKernelEx(&cfg, kernel, (const cpx<T>*)ca, (const cpx<T>*)cb, (const W*)w,
                         (cpx<double>*)out, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int launch(const void* ca, const void* cb, const void* w, void* out, int M, int na, int nb, int k,
           int sym, int split, cudaStream_t stream) {
  if (M <= 0 || na <= 0 || nb <= 0 || k <= 0) return 0;
  Params p{};
  p.na = na;
  p.nb = nb;
  p.k = k;
  p.sym = sym != 0;
  p.nt = (k + WT - 1) / WT;
  p.njobs = p.sym ? p.nt * (p.nt + 1) / 2 : p.nt * p.nt;
  p.split = split;
  const int pairs = ((na + BT - 1) / BT) * ((nb + BT - 1) / BT);
  if ((p.sym && (na != nb || na > BT)) || split < 1 || split > MAX_SPLIT ||
      split > p.njobs || M > 65535 || pairs > 65535)
    return (int)cudaErrorInvalidValue;
  // three jobs a warp in flight where they fit (complex64), else two
  if (WARPS * 4 * sizeof(Stage<T, W>) + (NV + 32 * WARPS) * sizeof(double) <= SMEM_MAX)
    return launch_ring<T, W, 4>(p, ca, cb, w, out, M, pairs, stream);
  return launch_ring<T, W, 3>(p, ca, cb, w, out, M, pairs, stream);
}

}  // namespace

extern "C" {

// ca (M, na, k, k), cb (M, nb, k, k) complex (interleaved), w (M, k) real,
// out (M, na, nb) complex128.  sym: ca and cb are one stack of at most 4
// bands (cb is not read; F is symmetric and written whole).  split: the
// blocks of a cluster that share an m's jobs (ops/projections.py
// fisher_trace_plan).
int fisher_trace_c64_w32(const void* ca, const void* cb, const void* w, void* out, int M, int na,
                         int nb, int k, int sym, int split, void* stream) {
  return launch<float, float>(ca, cb, w, out, M, na, nb, k, sym, split, (cudaStream_t)stream);
}

int fisher_trace_c64_w64(const void* ca, const void* cb, const void* w, void* out, int M, int na,
                         int nb, int k, int sym, int split, void* stream) {
  return launch<float, double>(ca, cb, w, out, M, na, nb, k, sym, split, (cudaStream_t)stream);
}

int fisher_trace_c128_w32(const void* ca, const void* cb, const void* w, void* out, int M, int na,
                          int nb, int k, int sym, int split, void* stream) {
  return launch<double, float>(ca, cb, w, out, M, na, nb, k, sym, split, (cudaStream_t)stream);
}

int fisher_trace_c128_w64(const void* ca, const void* cb, const void* w, void* out, int M, int na,
                          int nb, int k, int sym, int split, void* stream) {
  return launch<double, double>(ca, cb, w, out, M, na, nb, k, sym, split, (cudaStream_t)stream);
}

}  // extern "C"
