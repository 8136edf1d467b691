// K1+K2: cylinder beams from bank rows fused with the visibility maps, and
// their Stokes form with the dipole pattern (K19).
//
// Replaces the JAX programs driftscan_tpu/telescope/cylbeam.py
// _beam_device_kernel (:133, the per-pixel beam of a bank row, with the
// dipole polpattern of driftscan_tpu/ops/kernels.py:297 for polarised feeds)
// fused with driftscan_tpu/ops/kernels.py unpol_visibility_map_split (:203)
// and stokes_visibility_map_split (:214): solid angles, fringe and the
// normalised maps of every stock cylinder in single precision.  Plain
// versions: driftscan_tpu_torch.ops.kernels.bank_visibility_maps_ref and
// bank_stokes_maps_ref.
//
// The three launches and the pixel-outer, unit-inner map pass are
// vis_map.cuh's, with the beams formed in the block from the batch's unique
// bank rows (BankBeams): the solid-angle pass reads each pixel block of the
// grid once and sums every row over it; the map pass reads its tile's cart
// and horizon once into registers, evaluates each unique row once a pixel
// into shared memory (in host_vis_stage groups where they do not fit; a
// unit's row j in another group is evaluated in place), then walks every
// unit and forms only the fringe, the product and the stores.  A batch holds
// one row per (frequency, beam class), a few against tens of units, so the
// beam is formed once a pixel rather than once a unit.
//
// A row's beam at pixel n: the linear interpolation of its Fraunhofer table
// fx on its uniform grid at x = n.xhat, times the ExpTan N-S profile at
// y = n.yhat (exp(-alpha tan^2), alpha = ln 2 / (2 tan^2(fwhm / 2)), formed
// here from the row's fwhm), times the horizon.  A dipole beam is that
// amplitude times the unit projection of the dipole axis on the local
// (theta_hat, phi_hat) plane.  The frame is formed from the cartesian n (rho
// = |(n_x, n_y)|, cos phi = n_x / rho, sin phi = n_y / rho), not through
// arccos/arctan2, which lose float32 precision near the pole; at rho = 0 it
// is phi = 0, and a dipole along n gets a zero vector, never 0/0.
//
// What bounds it on an H100: bytes.  The maps written (8 bytes a pixel a
// unit a Stokes component), the grid (cart and horizon, 16 bytes a pixel)
// and the bank rows (a few KB, L1 resident) read once: at the bench
// cylinder's first chunk (64 units x 1,047,552 padded pixels) 536 MB of
// maps and 17 MB of grid, 0.165 ms at 3.35 TB/s.  The arithmetic a map
// value is the float64 turns (3 multiply-adds, a floor), one sincospif and
// a few float32 products; the beams' (an interpolation, an exp, a tan and a
// division, the frame and dipole projection in the Stokes form) is paid
// once per pixel and row.

#include "vis_map.cuh"

namespace {

constexpr int PAR_LEN = 12;  // kx0, inv_step, fwhm_ns, xhat(3), yhat(3), dipole(3)

// Bank row b at a pixel: NCOMP 1 the amplitude, NCOMP 2 its (theta_hat,
// phi_hat) dipole components.
template <int NCOMP>
struct BankBeams {
  using ET = float;
  static constexpr bool kCart = true;
  static constexpr bool kAllRows = true;
  const float* fx;   // (nb, nfx) Fraunhofer tables
  const float* par;  // (nb, PAR_LEN)
  int nfx;

  __device__ __forceinline__ void eval(int b, long long, float cx, float cy, float cz, float h,
                                       float (&v)[NCOMP]) const {
    const float* pr = par + PAR_LEN * b;
    const float x = cx * __ldg(pr + 3) + cy * __ldg(pr + 4) + cz * __ldg(pr + 5);
    const float y = cx * __ldg(pr + 6) + cy * __ldg(pr + 7) + cz * __ldg(pr + 8);
    const float t = (x - __ldg(pr)) * __ldg(pr + 1);
    // clip(floor(t), 0, nfx - 2): truncation equals floor for t >= 0
    const int i0 = min((int)fmaxf(t, 0.f), nfx - 2);
    const float frac = t - (float)i0;
    const float* row = fx + (long long)b * nfx;
    const float ew = __ldg(row + i0) * (1.f - frac) + __ldg(row + i0 + 1) * frac;
    const float st2 = y * y;
    // the plain version's 1e-100 guard is 0 in float32
    const float tan2 = st2 / (1.f - st2);
    const float tw = tanf(0.5f * __ldg(pr + 2));
    const float alpha = 0.693147182f / (2.f * (tw * tw));
    const float amp = ew * expf(-alpha * tan2) * h;
    if constexpr (NCOMP == 1) {
      v[0] = amp;
    } else {
      const float rho = sqrtf(cx * cx + cy * cy);
      const bool pole = rho == 0.f;
      const float cp = pole ? 1.f : cx / rho;
      const float sp = pole ? 0.f : cy / rho;
      const float dx = __ldg(pr + 9), dy = __ldg(pr + 10), dz = __ldg(pr + 11);
      const float vt = cz * cp * dx + cz * sp * dy - rho * dz;
      const float vp = cp * dy - sp * dx;
      const float norm = sqrtf(vt * vt + vp * vp);
      const float inv = norm > 0.f ? 1.f / norm : 0.f;
      v[0] = amp * (vt * inv);
      v[1] = amp * (vp * inv);
    }
  }
};

template <int NCOMP>
int launch(const void* cart, const void* hor, const void* fx, const void* par, const void* ii,
           const void* jj, const void* uv3, void* out, void* scratch, long long scratch_len,
           double pxarea, long long npix, int nu, int nb, int nfx, int npol, int nstage,
           cudaStream_t stream) {
  if (nfx < 2) return (int)cudaErrorInvalidValue;
  const BankBeams<NCOMP> src{static_cast<const float*>(fx), static_cast<const float*>(par), nfx};
  return vismap::launch<float, false, NCOMP>(src, cart, hor, ii, jj, uv3, out, scratch,
                                             scratch_len, pxarea, npix, nu, nb, npol, nstage,
                                             stream);
}

}  // namespace

extern "C" {

// cart (npix, 3) and horizon (npix,) float32; fx (nb, nfx) and par (nb, 12)
// float32 bank rows of the batch's unique beams; ii, jj (nu,) int64 row
// indices, uv3 (nu, 3) float64 baselines; out (nu, npol, npix) complex64
// (npol 1 for ncomp 1: the scalar maps; ncomp 2: the Stokes maps of the
// rows' dipole beams).  scratch holds scratch_len floats, at least nb
// (ceil(npix / 1024) + 1): the Omega partials, then the solid angles.
// nstage rows are staged at once (ops/kernels.py host_vis_stage).
int bank_maps_f32(const void* cart, const void* hor, const void* fx, const void* par,
                  const void* ii, const void* jj, const void* uv3, void* out, void* scratch,
                  long long scratch_len, double pxarea, long long npix, int nu, int nb,
                  int ncomp, int nfx, int npol, int nstage, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ncomp == 1)
    return launch<1>(cart, hor, fx, par, ii, jj, uv3, out, scratch, scratch_len, pxarea, npix,
                     nu, nb, nfx, npol, nstage, s);
  if (ncomp == 2)
    return launch<2>(cart, hor, fx, par, ii, jj, uv3, out, scratch, scratch_len, pxarea, npix,
                     nu, nb, nfx, npol, nstage, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
