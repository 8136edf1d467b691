// K2 on host-evaluated beams: solid angles and visibility / Stokes maps.
//
// Replaces the JAX programs driftscan_tpu/ops/kernels.py
// unpol_visibility_map (:189) and stokes_visibility_map (:196), with the
// fringe (:41), beam_solid_angle (:72), unpolarised_visibility (:84) and
// stokes_visibility (:101) they fuse: the maps of every telescope whose
// beams are arrays evaluated on the host rather than cylinder bank rows
// (dish arrays, GMRT, focal planes, cylinders that override their beam, and
// every cylinder in double precision).  Host beams need not be real, so B_j
// is conjugated in every product.  One source serves the scalar and the
// Stokes form (NCOMP 1 or 2 beam components a pixel), real or complex
// beams, on a float32 or float64 grid.  Plain versions:
// driftscan_tpu_torch.ops.kernels.host_visibility_maps_ref and
// host_stokes_maps_ref.
//
// The three launches and the pixel-outer, unit-inner map pass are
// vis_map.cuh's, with the beams read from the (nb, npix[, 2]) device array
// (HostBeams): one block a beam in the solid-angle pass, and in the map pass
// each block stages its pixels of the batch's unique beams in shared memory
// once; a unit's beam j in another staging group is read in place.
//
// What bounds it on an H100: bytes.  The maps written (8 or 16 bytes a
// pixel a unit a Stokes component), the grid (cart and horizon) and the
// unique beams read once: at the [dish] path's first chunk (16 units x
// 4,192,256 padded pixels, float64) 1.07 GB of maps and 0.17 GB of grid
// and beam, 0.37 ms at 3.35 TB/s.  The float64 arithmetic a map value
// (3 multiply-adds of the turns, a floor, a sincospi -- ~20 float64
// operations: a reduction and two short polynomials -- and ~10 for the
// products) is ~35 operations, ~2.3 GFLOP at that chunk, 0.07 ms on the
// 34 TFLOP/s float64 CUDA cores, and less on the half of the sky below
// the horizon.  A unit-outer grid (pixel blocks x units) would re-read the
// grid and both beams from device memory for every unit, ~4.3 GB at that
// chunk; here the grid and the beams leave device memory once per pixel
// tile.

#include "vis_map.cuh"

namespace {

using vismap::Elem;

// Beam b at pixel p from the (nb, npix, NCOMP) array.
template <typename T, bool CPLX, int NCOMP>
struct HostBeams {
  using ET = typename Elem<T, CPLX>::type;
  static constexpr bool kCart = false;
  static constexpr bool kAllRows = false;
  const ET* beams;
  long long npix;

  __device__ __forceinline__ void eval(int b, long long p, T, T, T, T, ET (&v)[NCOMP]) const {
    const ET* rec = beams + ((long long)b * npix + p) * NCOMP;
#pragma unroll
    for (int c = 0; c < NCOMP; ++c) v[c] = __ldg(rec + c);
  }
};

template <typename T, bool CPLX, int NCOMP>
int launch(const void* cart, const void* hor, const void* beams, const void* ii,
           const void* jj, const void* uv3, void* out, void* scratch, long long scratch_len,
           double pxarea, long long npix, int nu, int nb, int npol, int nstage,
           cudaStream_t stream) {
  using S = HostBeams<T, CPLX, NCOMP>;
  const S src{static_cast<const typename S::ET*>(beams), npix};
  return vismap::launch<T, CPLX, NCOMP>(src, cart, hor, ii, jj, uv3, out, scratch, scratch_len,
                                        pxarea, npix, nu, nb, npol, nstage, stream);
}

template <typename T>
int dispatch(const void* cart, const void* hor, const void* beams, const void* ii,
             const void* jj, const void* uv3, void* out, void* scratch, long long scratch_len,
             double pxarea, long long npix, int nu, int nb, int ncomp, int cplx, int npol,
             int nstage, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define HOST_VIS_ARGS \
  cart, hor, beams, ii, jj, uv3, out, scratch, scratch_len, pxarea, npix, nu, nb, npol, nstage, s
  if (ncomp == 1) {
    return cplx ? launch<T, true, 1>(HOST_VIS_ARGS) : launch<T, false, 1>(HOST_VIS_ARGS);
  }
  if (ncomp == 2) {
    return cplx ? launch<T, true, 2>(HOST_VIS_ARGS) : launch<T, false, 2>(HOST_VIS_ARGS);
  }
#undef HOST_VIS_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// cart (npix, 3) and horizon (npix,) of the grid's type; beams (nb, npix)
// scalar or (nb, npix, 2) field patterns, real or complex (interleaved),
// of that type; ii, jj (nu,) int64 beam indices, uv3 (nu, 3) float64
// baselines; out (nu, npol, npix) complex (npol 1 for ncomp 1).  scratch
// holds scratch_len values of the grid's type, at least nb (ceil(npix /
// 1024) + 1): the Omega partials, then the solid angles.  nstage beams are
// staged at once (ops/kernels.py host_vis_stage).
int host_maps_f32(const void* cart, const void* hor, const void* beams, const void* ii,
                  const void* jj, const void* uv3, void* out, void* scratch,
                  long long scratch_len, double pxarea, long long npix, int nu, int nb,
                  int ncomp, int cplx, int npol, int nstage, void* stream) {
  return dispatch<float>(cart, hor, beams, ii, jj, uv3, out, scratch, scratch_len, pxarea, npix,
                         nu, nb, ncomp, cplx, npol, nstage, stream);
}

int host_maps_f64(const void* cart, const void* hor, const void* beams, const void* ii,
                  const void* jj, const void* uv3, void* out, void* scratch,
                  long long scratch_len, double pxarea, long long npix, int nu, int nb,
                  int ncomp, int cplx, int npol, int nstage, void* stream) {
  return dispatch<double>(cart, hor, beams, ii, jj, uv3, out, scratch, scratch_len, pxarea,
                          npix, nu, nb, ncomp, cplx, npol, nstage, stream);
}

}  // extern "C"
