"""Measurements on one GPU that the smoke run does not repeat: each module
is a script, run from a checkout as ``python3 driftscan_tpu_torch/experiments/<name>.py``."""
