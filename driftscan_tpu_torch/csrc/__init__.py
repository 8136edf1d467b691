"""Sources of the hand-written kernels (CUDA C++ ``*.cu`` and the shared
``*.cuh`` headers, built by ``backend.build``) and of the host codecs
(``*.cpp``, built by ``backend.build_host``)."""
