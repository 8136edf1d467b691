"""Legacy cylinder model using simple sinc beams.

Port of ``driftscan_tpu/telescope/oldcylinder.py``.  Like the JAX module it
is not in the manager's registry: a YAML file reaches it by the plugin
form ``telescope: {type: {module: driftscan_tpu_torch.telescope.oldcylinder,
class: PolarisedCylinderTelescope}, ...}``.  Its beams override the stock
cylinder's, so :meth:`CylinderTelescope._bank_beams_apply` sends them to
the host: ``beam`` / ``beamx`` / ``beamy`` are evaluated on the compact
grid and the maps take K2-host (scalar or Stokes), then K3+K5.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..core import telescope, visibility
from ..ops import kernels
from . import cylinder as newcylinder


class CylinderTelescope(newcylinder.CylinderTelescope):
    """Legacy cylinder base (layout identical to the modern class)."""


class UnpolarisedCylinderTelescope(CylinderTelescope, telescope.SimpleUnpolarisedTelescope):
    """Unpolarised cylinder with a sinc E-W beam."""

    def beam(self, feed, freq):
        return visibility.cylinder_beam(
            self._angpos, self.zenith, self.cylinder_width / self.wavelengths[freq]
        )


class PolarisedCylinderTelescope(CylinderTelescope, telescope.SimplePolarisedTelescope):
    """Legacy polarised cylinder: sinc beams on fixed polarisation axes."""

    illumination_x = config.Property(proptype=float, default=1.0)
    illumination_y = config.Property(proptype=float, default=1.0)

    ortho_pol = config.Property(proptype=bool, default=True)

    def _pol_beam(self, bpat, along_phi):
        bm = np.zeros(self._angpos.shape, dtype=np.float64)
        if self.ortho_pol:
            bm[:, 1 if along_phi else 0] = bpat
        else:
            thatz, phatz = (v.numpy() for v in kernels.thetaphi_plane_cart(
                torch.as_tensor(self.zenith, dtype=torch.float64)))
            thatp, phatp = (v.numpy() for v in kernels.thetaphi_plane_cart(
                torch.as_tensor(self._angpos, dtype=torch.float64)))
            ref = phatz if along_phi else thatz
            bm[:, 0] = (thatp @ ref) * bpat
            bm[:, 1] = (phatp @ ref) * bpat
        return bm

    def beamx(self, feed, freq):
        bpat = visibility.cylinder_beam(
            self._angpos,
            self.zenith,
            self.illumination_x * self.cylinder_width / self.wavelengths[freq],
        )
        return self._pol_beam(bpat, along_phi=True)

    def beamy(self, feed, freq):
        bpat = visibility.cylinder_beam(
            self._angpos,
            self.zenith,
            self.illumination_y * self.cylinder_width / self.wavelengths[freq],
        )
        return self._pol_beam(bpat, along_phi=False)
