"""Sources of the hand-written kernels (CUDA C++ ``*.cu`` and Triton).

The Triton modules here import ``triton`` at the top: import them only
from the function that launches their kernel.
"""
