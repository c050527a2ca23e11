"""The port's native kernels: CUDA sources built with nvcc, host sources
with g++ (``build.py``), their launchers and plain versions.  Importing
the package registers the eval path's kernels as ``torch.ops.dafne`` ops
(``library.py``)."""

from dafne_torch.ops.kernels import library  # noqa: F401
