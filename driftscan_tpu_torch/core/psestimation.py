"""Power-spectrum band functions (the part the Fisher bands need).

Port of ``bandfunc_2d_polar`` from ``driftscan_tpu/core/psestimation.py``;
the file-based estimators are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import numpy as np


def bandfunc_2d_polar(ks, ke, ts, te):
    """Indicator of the polar annulus ks <= k < ke, ts <= theta <= te."""

    def band(k, mu):
        theta = np.arccos(np.clip(mu, -1.0, 1.0))
        inside = (k >= ks) & (k < ke) & (theta >= ts) & (theta <= te)
        return inside.astype(np.float64)

    return band
