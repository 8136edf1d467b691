"""Timestream simulation and analysis pipeline of the port (``drift-runpipeline``):
:mod:`.timestream` (simulate -> m-modes -> SVD / KL modes -> maps and power
spectra) and :mod:`.pipeline` (the YAML-driven manager)."""
