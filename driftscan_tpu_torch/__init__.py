"""driftscan_tpu_torch — the PyTorch and CUDA port of driftscan_tpu.

The port runs the m-mode product path (beam transfer matrices, per-m SVD
compression, the factored KL pencil and the quadratic-estimator Fisher
matrix) on an NVIDIA Hopper GPU.  Plain tensor work is PyTorch with
native complex dtypes; the fused device programs of the JAX package are
kernels written by hand (``csrc/``), each with a plain PyTorch version
beside it that the CPU tests hold against the JAX package.

The package imports no JAX: host-only modules of ``driftscan_tpu`` are
ported, not imported.
"""

import torch

# The JAX package pins "highest" matmul precision: never let a float32
# product or convolution drop to TF32 on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
