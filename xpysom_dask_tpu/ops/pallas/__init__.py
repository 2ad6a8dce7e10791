"""Pallas kernels for the SOM hot path on NVIDIA Hopper.

``bmu``: the fused BMU search (GEMM on the tensor cores + running
argmin, Triton route) for the euclidean and cosine activations. The
reference's one native kernel, a CUDA ``ReductionKernel`` for Manhattan
distance (reference distances.py:110-118), has no counterpart here: XLA
fuses the broadcast ``abs``-reduce form (``ops.distances``) into one
reduction itself.
"""

from . import bmu  # noqa: F401

__all__ = ["bmu"]
