"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions.

Modules import no CUDA toolchain: a kernel library is built with ``nvcc``
and loaded the first time a CUDA tensor reaches its wrapper
(:mod:`.build`).
"""
