"""Adopt the port's recorded engine picks as library defaults.

Port of ``driftscan_tpu/engine_picks.py``.  A perf lever ships behind a
switch whose default flips only on an accuracy-gated A/B measured on the
card, kept as a small JSON decision record.  The product CLI reads the
records (:func:`adopt_decision_records`, called by
``ProductManager.from_config``), so that a measured configuration is the
shipped one.

Resolution order: the lever's environment variable, then the record, then
the library default.  A missing or garbled record keeps the default.

Only the port's own records are read: the directory ``decisions/`` of
this package (it ships none) or ``$DRIFTSCAN_TPU_TORCH_DECISION_DIR``.
The JAX package's records (the repo's ``doc/``, or
``$DRIFTSCAN_TPU_DECISION_DIR``) are TPU measurements and are never read.

Of the JAX package's four levers one applies here:

``whiten_ab.json`` ``whiten_pick`` -> ``fpencil._WHITEN_IMPL``
    (``DRIFTSCAN_TPU_WHITEN_IMPL``; "solve", "factored" or "refined").

``beam_factor_pick`` and ``sht_precision_pick`` select TPU layouts and
matmul precision tiers that the port does not have (its beam factor is one
einsum, its SHT runs the hand-written Legendre kernels in the maps'
precision), and ``filter_precision_pick`` was ruled not applicable to the
top-band engine, whose filter step is the float64 kernel K17.
"""

from __future__ import annotations

import json
import logging
import os

import torch

logger = logging.getLogger(__name__)

_PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
_DEFAULT_DIR = os.path.join(_PACKAGE_DIR, "decisions")
# the JAX package's TPU records, never read
_TPU_RECORDS = os.path.join(os.path.dirname(_PACKAGE_DIR), "doc")

ENV_DIR = "DRIFTSCAN_TPU_TORCH_DECISION_DIR"
WHITEN_ENV = "DRIFTSCAN_TPU_WHITEN_IMPL"


def _read(path: str, key: str):
    try:
        with open(path) as f:
            rec = json.load(f)
        return rec.get(key) if isinstance(rec, dict) else None
    except (OSError, ValueError):
        return None


def _is_tpu_records(directory: str) -> bool:
    d = os.path.realpath(directory)
    top = os.path.realpath(_TPU_RECORDS)
    return d == top or d.startswith(top + os.sep)


def adopt_decision_records(directory: str | None = None, require_accelerator: bool = True,
                           device=None) -> dict:
    """Apply every recorded pick whose environment variable is unset.

    ``directory`` defaults to ``$DRIFTSCAN_TPU_TORCH_DECISION_DIR``, else
    the package's ``decisions/``; the repo's ``doc/`` is refused.  With
    ``require_accelerator`` nothing is adopted unless the run is on a card
    (``device``, or a visible card when None): on the CPU the defaults are
    the right numerics.  Returns {lever: adopted value}.
    """
    d = directory or os.environ.get(ENV_DIR) or _DEFAULT_DIR
    adopted = {}
    if _is_tpu_records(d):
        logger.warning("not reading %s: the JAX package's TPU records", d)
        return adopted
    if require_accelerator:
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return adopted

    from .ops import fpencil

    if os.environ.get(WHITEN_ENV) is None:
        wp = _read(os.path.join(d, "whiten_ab.json"), "whiten_pick")
        if wp in fpencil._WHITEN_IMPLS:
            fpencil._WHITEN_IMPL = wp
            adopted["whiten"] = wp
        elif wp is not None:
            logger.warning("ignoring whiten_pick %r of %s", wp, d)
    return adopted
