"""The port's engine picks (``driftscan_tpu_torch.engine_picks``): a
recorded pick is adopted where no environment variable is set, a missing
or garbled record keeps the default, nothing is adopted on the CPU unless
asked, the JAX package's TPU records (the repo's ``doc/``,
``DRIFTSCAN_TPU_DECISION_DIR``) are never read, and
``ProductManager.from_config`` adopts before it builds anything.
"""

import builtins
import json
import os

import pytest

from driftscan_tpu_torch import engine_picks
from driftscan_tpu_torch.core import manager
from driftscan_tpu_torch.ops import fpencil

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def default_lever(monkeypatch):
    """Every case starts from the default whitening, with no environment
    variable, and leaves the lever as it found it."""
    monkeypatch.setattr(fpencil, "_WHITEN_IMPL", "solve")
    for var in (engine_picks.WHITEN_ENV, engine_picks.ENV_DIR, "DRIFTSCAN_TPU_DECISION_DIR"):
        monkeypatch.delenv(var, raising=False)


def _record(directory, pick):
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "whiten_ab.json").write_text(json.dumps({"whiten_pick": pick}))
    return str(directory)


def test_record_over_default(tmp_path):
    d = _record(tmp_path / "rec", "refined")
    got = engine_picks.adopt_decision_records(d, require_accelerator=False)
    assert got == {"whiten": "refined"} and fpencil._WHITEN_IMPL == "refined"


def test_env_var_over_record(tmp_path, monkeypatch):
    d = _record(tmp_path / "rec", "refined")
    monkeypatch.setenv(engine_picks.WHITEN_ENV, "factored")
    assert engine_picks.adopt_decision_records(d, require_accelerator=False) == {}
    assert fpencil._WHITEN_IMPL == "solve"


def test_env_directory(tmp_path, monkeypatch):
    monkeypatch.setenv(engine_picks.ENV_DIR, _record(tmp_path / "rec", "factored"))
    assert engine_picks.adopt_decision_records(require_accelerator=False) == {
        "whiten": "factored"}


@pytest.mark.parametrize("content", [None, "{not json", json.dumps([1, 2]),
                                     json.dumps({"whiten_pick": "householder"}),
                                     json.dumps({"other": "solve"})])
def test_missing_or_garbled_record_keeps_default(tmp_path, content):
    d = tmp_path / "rec"
    d.mkdir()
    if content is not None:
        (d / "whiten_ab.json").write_text(content)
    assert engine_picks.adopt_decision_records(str(d), require_accelerator=False) == {}
    assert fpencil._WHITEN_IMPL == "solve"


def test_nothing_on_the_cpu(tmp_path):
    d = _record(tmp_path / "rec", "refined")
    assert engine_picks.adopt_decision_records(d, device="cpu") == {}
    assert fpencil._WHITEN_IMPL == "solve"


def test_never_reads_the_tpu_records(tmp_path, monkeypatch):
    """Neither the repo's doc/ (which holds a whiten_ab.json) nor
    DRIFTSCAN_TPU_DECISION_DIR pointing at a record is opened."""
    doc = os.path.join(REPO, "doc")
    assert os.path.exists(os.path.join(doc, "whiten_ab.json"))
    opened = []
    real_open = builtins.open
    monkeypatch.setattr(builtins, "open",
                        lambda path, *a, **k: opened.append(str(path)) or real_open(path, *a, **k))
    monkeypatch.setenv("DRIFTSCAN_TPU_DECISION_DIR", _record(tmp_path / "tpu", "refined"))
    assert engine_picks.adopt_decision_records(doc, require_accelerator=False) == {}
    assert engine_picks.adopt_decision_records(os.path.join(doc, "."),
                                               require_accelerator=False) == {}
    assert engine_picks.adopt_decision_records(require_accelerator=False) == {}
    assert fpencil._WHITEN_IMPL == "solve"
    assert not [p for p in opened if p.startswith((doc, str(tmp_path / "tpu")))]
    # the package ships no record
    assert not os.path.exists(engine_picks._DEFAULT_DIR)


def test_from_config_adopts_on_its_device(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(engine_picks, "adopt_decision_records",
                        lambda **kw: calls.append(kw) or {})
    cfg = tmp_path / "c.yaml"
    cfg.write_text(
        "config:\n  output_directory: %s\ntelescope:\n  type: UnpolarisedCylinder\n"
        "  num_freq: 2\n  num_feeds: 2\n  num_cylinders: 2\n" % (tmp_path / "out")
    )
    m = manager.ProductManager.from_config(str(cfg), device="cpu")
    assert calls == [{"device": m.device}]
