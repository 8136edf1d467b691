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
// X (n, Cc, nl) and Y (m, Cd, nl) complex, C (nl, Cc, Cd) real, read in
// the caller's layouts.  X and Y may differ (the sky form pairs two
// frequencies), so the result is not assumed Hermitian.
//
// XLA writes the (b, i, l, d) intermediate T = X C to device memory and
// contracts it in a second program.  Here one block owns a TILE x TILE
// output tile (TILE 32 or 64, chosen by the wrapper from n and m) of one
// batch item and walks the contraction axis k = (d, l) in chunks of 16
// slots: DC = min(Cd, 16) values of d times LC = 16 / DC consecutive l.
// For each chunk it
//   * stages the chunk's operands -- Y's 16 x TILE slice, X's TILE rows of
//     the chunk's (c, l) and C's (l, c, d) values -- into shared memory with
//     cp.async, one chunk ahead (three for a 32-edge tile, whose chunks are
//     a quarter of the work), so the copies run under the work of the
//     chunks before;
//   * forms that chunk of T = X C on the CUDA cores from the staged values
//     (in the operands' precision, stored as float64), each thread a row,
//     an l and four values of d, so that one X value read serves four
//     products (where Cc * LC > 16 the X and C values are read in place,
//     through L1/L2, one slot a thread, in float64);
//   * multiplies T conj(Y)^T on the float64 tensor cores (mma.sync
//     m16n8k4.f64, 8 warps of 32 x 16 or 16 x 8 outputs): with the planes
//     of each complex operand, Re += Tr Yr + Ti Yi and Im += Ti Yr - Tr Yi,
//     four real products per complex one, the first product of every
//     accumulator issued before the second.  Products of 16 x 8 sub-tiles
//     wholly past n or m are skipped, so a 44 x 44 output costs 48 x 48.
// Two blocks share an SM (128 registers a thread), so that one stages and
// forms while the other multiplies.
// complex64: T is formed in float32 and widened once, Y is widened as it
// is read, and the product is summed in float64 and rounded to float32 once
// at the end: on the H100 the float64 tensor cores (67 TFLOP/s) run as fast
// as the float32 CUDA cores, and one code path needs no split-precision
// bookkeeping.  T never reaches device memory.
//
// Few output tiles (the product files' KL bases hold tens of modes per m):
// the chunks are split across the nsplit blocks of a thread-block cluster
// (nsplit <= 8, cluster rank = split).  Each block leaves its partial tile
// in its shared memory; after a cluster barrier every rank sums a band of
// the tile's rows over all ranks' tiles (distributed shared memory) in rank
// order and writes it.  One launch, no scratch in device memory, no
// atomics: two launches give the same bits.
//
// What bounds it on an H100: at the band form's nkl = n = 352 the float64
// tensor cores (nl (4 n Cc Cd + 8 n m Cd) flops per item, 7.4 GFLOP for the
// bench's four bands, 0.11 ms at 67 TFLOP/s); at the file path's nkl ~ 52
// and the sky form's 44 x 44, launch latency and the chunk loop's staging.
// Measured (clock64 phases, PERF.md), the staging of each chunk -- some
// 2,000 16-byte copies from runs of 32 bytes, every 64 x 64 tile reading
// its own X and Y rows, ~0.6 GB from L2 at n = 352 -- and the forming of T
// take as long as the product: the kernel runs at ~25% of the tensor
// cores' rate there.
//
// Plain version: driftscan_tpu_torch.ops.projections.sandwich_ref.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mma_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int KC = 16;        // contraction slots (d, l) per chunk
constexpr int XK = 16;        // staged X rows (c, l) per chunk, at most
constexpr int THREADS = 256;  // 8 warps: 2 along rows x 4 along columns
constexpr int MAX_SPLIT = 8;   // portable cluster size
constexpr int MIN_BLOCKS = 2;  // blocks an SM holds at once (the register budget;
                               // SANDWICH_BLOCKS_PER_SM in ops/projections.py)

template <typename T>
struct cpx {
  T re, im;
};

// chunks in the cp.async ring: a 32-edge tile's chunk is a quarter of the
// work, so its copies go further ahead
template <int TILE>
__host__ __device__ constexpr int nstage() {
  return TILE == 32 ? 4 : 2;
}

// Shared memory: nstage() stages of raw operands (X rows, C values, Y rows
// of one chunk, as cp.async leaves them), one chunk of T in float64, and the
// partial tile of a split block (which reuses the stages once the loop is
// done).  Row strides keep each warp's fragment loads on distinct banks.
template <int TILE, typename T>
struct Layout {
  static constexpr int TS = TILE + 2;                              // cpx<double> per T row
  static constexpr int YS = sizeof(T) == 8 ? TILE + 2 : TILE + 4;  // cpx<T> per Y row
  static constexpr int XS = TILE + 2;                              // cpx<T> per X row
  static constexpr int PS = TILE + 1;                              // cpx<double> per partial row
  static constexpr size_t Y_BYTES = (size_t)KC * YS * sizeof(cpx<T>);
  static constexpr size_t X_BYTES = (size_t)XK * XS * sizeof(cpx<T>);
  static constexpr size_t C_BYTES = (size_t)XK * KC * sizeof(T);
  static constexpr size_t STAGE = Y_BYTES + X_BYTES + C_BYTES;
  static constexpr size_t T_BYTES = (size_t)KC * TS * sizeof(cpx<double>);
  static constexpr size_t P_BYTES = (size_t)TILE * PS * sizeof(cpx<double>);
  static constexpr size_t LOOP = nstage<TILE>() * STAGE + T_BYTES;
  static constexpr size_t SMEM = LOOP > P_BYTES ? LOOP : P_BYTES;
};

struct Plan {
  int B, n, m, Cc, Cd, nl;
  int dc, lc;    // d values and l values a chunk spans (dc * lc <= KC)
  int ndg;       // d groups: ceil(Cd / dc)
  int nchunks;   // ceil(nl / lc) * ndg
  int nsplit;    // blocks of a cluster sharing one tile's chunks
  int cps;       // chunks per split
  int xstaged;   // Cc * lc <= XK: X and C staged by cp.async, else read in place
};

template <int TILE, typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
sandwich_kernel(const cpx<T>* __restrict__ X, const cpx<T>* __restrict__ Y,
                const T* __restrict__ C, cpx<T>* __restrict__ out,
                const int* __restrict__ ix, const int* __restrict__ iy,
                const int* __restrict__ ic, Plan p) {
  using L = Layout<TILE, T>;
  constexpr int MT = TILE / 32;  // m16 sub-tiles a warp owns
  constexpr int NT = TILE / 32;  // n8 sub-tiles a warp owns
  extern __shared__ __align__(16) unsigned char smem[];
  auto y_at = [&](int s) { return reinterpret_cast<cpx<T>*>(smem + s * L::STAGE); };
  auto x_at = [&](int s) {
    return reinterpret_cast<cpx<T>*>(smem + s * L::STAGE + L::Y_BYTES);
  };
  auto c_at = [&](int s) {
    return reinterpret_cast<T*>(smem + s * L::STAGE + L::Y_BYTES + L::X_BYTES);
  };
  constexpr int NSTAGE = nstage<TILE>();
  cpx<double>* t_s = reinterpret_cast<cpx<double>*>(smem + NSTAGE * L::STAGE);  // [KC][TS]
  cpx<double>* p_s = reinterpret_cast<cpx<double>*>(smem);                 // [TILE][PS]

  const int split = blockIdx.x % p.nsplit;
  const int j0 = (blockIdx.x / p.nsplit) * TILE;
  const int i0 = blockIdx.y * TILE;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp & 1) * (TILE / 2);   // warp's first row in the tile
  const int wc = (warp >> 1) * (TILE / 4);  // warp's first column

  const long long KK = (long long)p.Cd * p.nl;
  const cpx<T>* xb = X + (long long)ix[b] * p.n * p.Cc * p.nl;
  const cpx<T>* yb = Y + (long long)iy[b] * p.m * KK;
  const T* cb = C + (long long)ic[b] * p.nl * p.Cc * p.Cd;
  const int xk = p.Cc * p.lc;  // staged X rows (c, l) of a chunk

  // decode tables: contraction slot kk -> (dl, li), staged X row kx -> (c, li)
  __shared__ int slot_tab[KC], x_tab[XK];
  if (tid < KC) slot_tab[tid] = ((tid / p.lc) << 8) | (tid % p.lc);
  if (tid < XK) x_tab[tid] = ((tid / p.lc) << 8) | (tid % p.lc);
  // this thread's C value of a staged chunk (xk * dc <= THREADS): (li, c, dl)
  const int c_dl = tid % p.dc, c_li = (tid / p.dc) / p.Cc, c_c = (tid / p.dc) % p.Cc;
  __syncthreads();

  const int q0 = split * p.cps;
  const int q1 = min(q0 + p.cps, p.nchunks);

  // chunk q: its first l and first d
  auto chunk = [&](int q, int& l0, int& d0) {
    const int lq = q / p.ndg;
    l0 = lq * p.lc;
    d0 = (q - lq * p.ndg) * p.dc;
  };

  // the raw operands of chunk q into stage s: Y rows (slot kk = dl * lc +
  // li), and with xstaged the X rows (c * lc + li) and C values (li, c, dl)
  auto stage = [&](int q, int s) {
    int l0, d0;
    chunk(q, l0, d0);
    cpx<T>* ys = y_at(s);
    {
      // KC divides THREADS: this thread's slot is the same for every row
      const int kk = tid % KC, code = slot_tab[kk];
      const int dl = code >> 8, l = l0 + (code & 255), d = d0 + dl;
      const bool slot_ok = dl < p.dc && d < p.Cd && l < p.nl;
      const cpx<T>* yk = yb + (long long)d * p.nl + l;
      for (int j = tid / KC; j < TILE; j += THREADS / KC) {
        const bool ok = slot_ok && j0 + j < p.m;
        mma::cp_async<sizeof(cpx<T>)>(ys + kk * L::YS + j, ok ? yk + (j0 + j) * KK : yb, ok);
      }
    }
    if (p.xstaged) {
      cpx<T>* xs = x_at(s);
      for (int e = tid; e < TILE * xk; e += THREADS) {
        const int i = e / xk, kx = e - i * xk, code = x_tab[kx];
        const int c = code >> 8, l = l0 + (code & 255);
        const bool ok = l < p.nl && i0 + i < p.n;
        const cpx<T>* src = ok ? xb + ((long long)(i0 + i) * p.Cc + c) * p.nl + l : xb;
        mma::cp_async<sizeof(cpx<T>)>(xs + kx * L::XS + i, src, ok);
      }
      if (tid < xk * p.dc) {
        const int l = l0 + c_li, d = d0 + c_dl;
        const bool ok = l < p.nl && d < p.Cd;
        const T* src = ok ? cb + ((long long)l * p.Cc + c_c) * p.Cd + d : cb;
        mma::cp_async<sizeof(T)>(c_at(s) + tid, src, ok);
      }
    }
    mma::cp_async_commit();
  };

  // T's chunk q: t_s[kk][i] = sum_c X[i0 + i, c, l] C[l, c, d].  Staged:
  // each item is a row, an l and four d values, so that every X value read
  // serves four products; else from device memory through L1, one slot an
  // item.
  const int ndq = (p.dc + 3) / 4;
  auto form_t = [&](int q, int s) {
    int l0, d0;
    chunk(q, l0, d0);
    if (p.xstaged) {
      const cpx<T>* xs = x_at(s);
      const T* cs = c_at(s);
      for (int e = tid; e < TILE * p.lc * ndq; e += THREADS) {
        const int i = e % TILE, rest = e / TILE;
        const int dq = rest / p.lc, li = rest - dq * p.lc;
        const int l = l0 + li;
        // in the operands' precision: complex64 converts each entry of T
        // once, not each product's operands
        T tr[4] = {0, 0, 0, 0}, ti[4] = {0, 0, 0, 0};
        if (l < p.nl && i0 + i < p.n) {
          for (int c = 0; c < p.Cc; ++c) {
            const cpx<T> xv = xs[(c * p.lc + li) * L::XS + i];
            const T* cv = cs + (li * p.Cc + c) * p.dc + 4 * dq;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (4 * dq + u < p.dc) {
                tr[u] = fma(xv.re, cv[u], tr[u]);
                ti[u] = fma(xv.im, cv[u], ti[u]);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int dl = 4 * dq + u;
          if (dl < p.dc) {
            const bool ok = d0 + dl < p.Cd;
            t_s[(dl * p.lc + li) * L::TS + i] =
                ok ? cpx<double>{(double)tr[u], (double)ti[u]} : cpx<double>{0.0, 0.0};
          }
        }
      }
      return;
    }
    // TILE divides THREADS: this thread's row is the same for every slot
    const int i = tid % TILE;
    for (int kk = tid / TILE; kk < KC; kk += THREADS / TILE) {
      const int code = slot_tab[kk];
      const int dl = code >> 8, li = code & 255;
      const int l = l0 + li, d = d0 + dl;
      double tr = 0.0, ti = 0.0;
      if (dl < p.dc && d < p.Cd && l < p.nl && i0 + i < p.n) {
        const cpx<T>* xp = xb + (long long)(i0 + i) * p.Cc * p.nl + l;
        const T* cp = cb + (long long)l * p.Cc * p.Cd + d;
        for (int c = 0; c < p.Cc; ++c) {
          const double cv = (double)__ldg(cp + c * p.Cd);
          const cpx<T> xv = xp[(long long)c * p.nl];
          tr = fma((double)xv.re, cv, tr);
          ti = fma((double)xv.im, cv, ti);
        }
      }
      t_s[kk * L::TS + i] = cpx<double>{tr, ti};
    }
  };

  // slots past dc * lc hold no (d, l): zero rows of T, never formed
  for (int e = p.dc * p.lc * TILE + tid; e < KC * TILE; e += THREADS)
    t_s[(e / TILE) * L::TS + e % TILE] = cpx<double>{0.0, 0.0};

  double acc_re[MT][NT][4], acc_im[MT][NT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc_re[a][c][r] = acc_im[a][c][r] = 0.0;

  // sub-tiles wholly past the output's edge are skipped (warp-uniform)
  bool row_on[MT], col_on[NT];
#pragma unroll
  for (int a = 0; a < MT; ++a) row_on[a] = i0 + wr + 16 * a < p.n;
#pragma unroll
  for (int c = 0; c < NT; ++c) col_on[c] = j0 + wc + 8 * c < p.m;

  // the first NSTAGE - 1 chunks go out ahead (an empty group past the end
  // keeps the count of groups)
  for (int a = 0; a < NSTAGE - 1; ++a) {
    if (q0 + a < q1) stage(q0 + a, a);
    else mma::cp_async_commit();
  }
  for (int q = q0; q < q1; ++q) {
    const int s = (q - q0) % NSTAGE;
    mma::cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // chunk q landed; the product of chunk q - 1 is done
    if (q + NSTAGE - 1 < q1) stage(q + NSTAGE - 1, (s + NSTAGE - 1) % NSTAGE);
    else mma::cp_async_commit();
    form_t(q, s);
    __syncthreads();
    const cpx<T>* ys = y_at(s);
#pragma unroll
    for (int k0 = 0; k0 < KC; k0 += 4) {
      double ar[MT][2], ai[MT][2];
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const cpx<double> v = t_s[(k0 + t) * L::TS + wr + 16 * a + 8 * h + g];
          ar[a][h] = v.re;
          ai[a][h] = v.im;
        }
      double br[NT], bi[NT];
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        const cpx<T> yv = ys[(k0 + t) * L::YS + wc + 8 * c + g];
        br[c] = (double)yv.re;
        bi[c] = (double)yv.im;
      }
      // the first product of every accumulator, then the second, so that
      // no product waits on the one before it in the same accumulator
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int c = 0; c < NT; ++c)
          if (row_on[a] && col_on[c]) {
            mma::dmma_16x8x4(acc_re[a][c], ar[a][0], ar[a][1], br[c]);
            mma::dmma_16x8x4(acc_im[a][c], ai[a][0], ai[a][1], br[c]);
          }
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int c = 0; c < NT; ++c)
          if (row_on[a] && col_on[c]) {
            mma::dmma_16x8x4(acc_re[a][c], ai[a][0], ai[a][1], bi[c]);
            mma::dmma_16x8x4(acc_im[a][c], -ar[a][0], -ar[a][1], bi[c]);
          }
    }
  }

  cpx<T>* ob = out + (long long)b * p.n * p.m;
  if (p.nsplit == 1) {
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int c = 0; c < NT; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + wr + 16 * a + g + 8 * (r >> 1);
          const int j = j0 + wc + 8 * c + 2 * t + (r & 1);
          if (i < p.n && j < p.m)
            ob[(long long)i * p.m + j] = cpx<T>{(T)acc_re[a][c][r], (T)acc_im[a][c][r]};
        }
    return;
  }

  // split: once every warp is past its last product, the partial tile into
  // shared memory (over the stages), then rank-ordered sums over the
  // cluster's tiles, each rank a band of rows
  __syncthreads();
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = wr + 16 * a + g + 8 * (r >> 1);
        const int j = wc + 8 * c + 2 * t + (r & 1);
        p_s[i * L::PS + j] = cpx<double>{acc_re[a][c][r], acc_im[a][c][r]};
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = (TILE + p.nsplit - 1) / p.nsplit;
  const int r0 = split * rows, r1 = min(r0 + rows, TILE);
  for (int e = r0 * TILE + tid; e < r1 * TILE; e += THREADS) {
    const int i = e / TILE, j = e % TILE;
    if (i0 + i >= p.n || j0 + j >= p.m) continue;
    double sr = 0.0, si = 0.0;
    for (int s = 0; s < p.nsplit; ++s) {
      const cpx<double>* rp = cluster.map_shared_rank(p_s, s);
      const cpx<double> v = rp[i * L::PS + j];
      sr += v.re;
      si += v.im;
    }
    ob[(long long)(i0 + i) * p.m + (j0 + j)] = cpx<T>{(T)sr, (T)si};
  }
  // no block leaves while another still reads its tile
  cluster.sync();
}

template <int TILE, typename T>
int launch_tile(const void* X, const void* Y, const void* C, void* out, const void* ix,
                const void* iy, const void* ic, const Plan& p, cudaStream_t stream) {
  auto kernel = sandwich_kernel<TILE, T>;
  const size_t smem = Layout<TILE, T>::SMEM;
  // the shared-memory opt-in, once per device (the small calls of the
  // product files are host-bound)
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= 64 || !smem_set[dev])) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess && dev < 64) smem_set[dev] = true;
  }
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((p.m + TILE - 1) / TILE) * p.nsplit, (p.n + TILE - 1) / TILE, p.B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, (const cpx<T>*)X, (const cpx<T>*)Y, (const T*)C,
                         (cpx<T>*)out, (const int*)ix, (const int*)iy, (const int*)ic, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* X, const void* Y, const void* C, void* out, const void* ix,
           const void* iy, const void* ic, int B, int n, int m, int Cc, int Cd, int nl,
           int tile, int dc, int nsplit, int cps, cudaStream_t stream) {
  if (B <= 0 || n <= 0 || m <= 0) return 0;
  Plan p{B, n, m, Cc, Cd, nl, dc, 0, 0, 0, nsplit, cps, 0};
  // the plan must tile the contraction and cover every chunk
  if (Cc < 1 || Cd < 1 || nl < 1 || dc < 1 || dc > KC || dc > Cd || B > 65535 ||
      nsplit < 1 || nsplit > MAX_SPLIT || cps < 1 || (tile != 32 && tile != 64))
    return (int)cudaErrorInvalidValue;
  p.lc = KC / dc;
  p.ndg = (Cd + dc - 1) / dc;
  p.nchunks = ((nl + p.lc - 1) / p.lc) * p.ndg;
  p.xstaged = Cc * p.lc <= XK;
  if ((long long)nsplit * cps < p.nchunks) return (int)cudaErrorInvalidValue;
  return tile == 32 ? launch_tile<32, T>(X, Y, C, out, ix, iy, ic, p, stream)
                    : launch_tile<64, T>(X, Y, C, out, ix, iy, ic, p, stream);
}

}  // namespace

extern "C" {

// X (Nx, n, Cc, nl), Y (Ny, m, Cd, nl) complex (interleaved), C (Nc, nl,
// Cc, Cd) real, out (B, n, m) complex; ix, iy, ic (B,) int32 pick each batch
// item's operands.  tile (32 or 64) is the output tile edge, dc the d values
// of a chunk (lc = 16 / dc values of l); the chunks of a tile go to the
// nsplit (<= 8) blocks of a cluster, cps each.
int sandwich_c64(const void* X, const void* Y, const void* C, void* out, const void* ix,
                 const void* iy, const void* ic, int B, int n, int m, int Cc, int Cd, int nl,
                 int tile, int dc, int nsplit, int cps, void* stream) {
  return launch<float>(X, Y, C, out, ix, iy, ic, B, n, m, Cc, Cd, nl, tile, dc, nsplit, cps,
                       (cudaStream_t)stream);
}

int sandwich_c128(const void* X, const void* Y, const void* C, void* out, const void* ix,
                  const void* iy, const void* ic, int B, int n, int m, int Cc, int Cd, int nl,
                  int tile, int dc, int nsplit, int cps, void* stream) {
  return launch<double>(X, Y, C, out, ix, iy, ic, B, n, m, Cc, Cd, nl, tile, dc, nsplit, cps,
                        (cudaStream_t)stream);
}

}  // extern "C"
