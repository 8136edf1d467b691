"""Exotic cylinder layouts and perturbed-beam analysis.

Port of ``driftscan_tpu/telescope/exotic_cylinder.py``: randomised
and gradient feed spacings, extra-feed variants, and CylinderPerturbed
whose doubled beamclasses hold beam-width derivative "feeds" for
perturbative beam analysis.  The layout classes change feed positions
only, so they keep the stock beam and, in single precision, the device
beam bank; CylinderPerturbed overrides ``beamx`` / ``beamy`` and takes the
host-beam path.
"""

from __future__ import annotations

import numpy as np

from .. import config
from . import cylbeam, cylinder


def _column(cylinder_index, spacing, y_positions):
    """Assemble an (n, 2) feed-position array for one cylinder column.

    x is constant (the cylinder's east-west offset), y is the given
    along-cylinder coordinate list.
    """
    y = np.asarray(y_positions, dtype=np.float64)
    x = np.full_like(y, cylinder_index * spacing)
    return np.stack([x, y], axis=1)


class RandomCylinder(cylinder.UnpolarisedCylinderTelescope):
    """Feeds jittered around the regular grid (seeded per cylinder).

    The jitter stream is the MT19937 sequence seeded with the cylinder
    index, matching the reference's seed/restore dance
    (driftscan's drift/telescope/exotic_cylinder.py:14-24) without
    touching global RNG state.
    """

    pos_sigma = 0.5

    def feed_positions_cylinder(self, cylinder_index):
        pos = super().feed_positions_cylinder(cylinder_index)

        jitter = np.random.RandomState(cylinder_index).standard_normal(len(pos))
        y = np.sort(pos[:, 1] + self.pos_sigma * self.feed_spacing * jitter)
        return _column(cylinder_index, self.cylinder_spacing, y)


class GradientCylinder(cylinder.UnpolarisedCylinderTelescope):
    """Quadratically increasing feed spacing (dense centre, sparse ends).

    Feed n sits at ``a*n + b*n^2/2`` where ``a`` is the minimum spacing
    (default: half the longest wavelength) and ``b`` is fixed by
    requiring the mean spacing to hit ``max_spacing`` at the far end
    (driftscan's drift/telescope/exotic_cylinder.py:30-52).
    """

    min_spacing = config.Property(proptype=float, default=-1.0)
    max_spacing = config.Property(proptype=float, default=20.0)

    def feed_positions_cylinder(self, cylinder_index):
        if not 0 <= cylinder_index < self.num_cylinders:
            raise ValueError("Cylinder index is invalid.")

        n = np.arange(self.num_feeds)
        last = self.num_feeds - 1
        a = self.min_spacing
        if a < 0.0:
            a = self.wavelengths[-1] / 2.0
        b = 2.0 * (self.max_spacing - a * last) / last**2

        return _column(
            cylinder_index, self.cylinder_spacing, a * n + 0.5 * b * n**2
        )


class CylinderExtra(cylinder.UnpolarisedCylinderTelescope):
    """Regular cylinder with extra feeds prepended at explicit positions."""

    extra_feeds = config.Property(proptype=np.array, default=np.zeros(0))

    def feed_positions_cylinder(self, cylinder_index):
        regular = super().feed_positions_cylinder(cylinder_index)
        extra = _column(
            cylinder_index, self.cylinder_spacing, self.extra_feeds
        )
        return np.concatenate([extra, regular], axis=0)


class CylinderShift(cylinder.UnpolarisedCylinderTelescope):
    """Cylinder with all feeds shifted along the cylinder."""

    shift = config.Property(proptype=float, default=0.0)

    def feed_positions_cylinder(self, cylinder_index):
        pos = super().feed_positions_cylinder(cylinder_index)
        return _column(
            cylinder_index,
            self.cylinder_spacing,
            pos[:, 1] + self.shift * cylinder_index,
        )


class CylinderPerturbed(cylinder.PolarisedCylinderTelescope):
    """Polarised cylinder with perturbation "feeds".

    Beamclasses double up: even classes are the X/Y fiducial beams, and
    each extra perturbation adds classes holding the numerical derivative
    of the beam with respect to the E-plane width.
    """

    npert = 2

    @property
    def beamclass(self):
        nsfeed = self._single_feedpositions.shape[0]
        return np.repeat(np.arange(2 * self.npert, dtype=np.int64), nsfeed)

    @property
    def feedpositions(self):
        return np.tile(self._single_feedpositions, (2 * self.npert, 1))

    def _pert_beam(self, beamfunc, feed, freq):
        """Fiducial beam or its d/d(fwhm_e) forward difference (1% step)."""
        width = self.cylinder_width / self.wavelengths[freq]

        def ev(fwhm_e):
            return np.asarray(
                beamfunc(self._angpos, self.zenith, width, fwhm_e, self.fwhm_h)
            )

        pert = int(self.beamclass[feed] // 2)
        if pert == 0:
            return ev(self.fwhm_e)
        if pert == 1:
            step = 0.01 * self.fwhm_e
            return (ev(self.fwhm_e + step) - ev(self.fwhm_e)) / step
        raise ValueError(f"Unsupported perturbation index {pert}")

    def beamx(self, feed, freq):
        return self._pert_beam(cylbeam.beam_x, feed, freq)

    def beamy(self, feed, freq):
        return self._pert_beam(cylbeam.beam_y, feed, freq)
