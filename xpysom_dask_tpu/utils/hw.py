"""Hardware introspection and mini-batch auto-sizing.

Counterpart of ``xpysom_dask/utils.py`` (``find_max_cuda_threads`` /
``find_cpu_cores``) and the ``n_parallel`` auto-sizing logic
(xpysom.py:242-251). The reference sized the chunk from CUDA thread
residency; here the target is bounding the transient ``(chunk, XY)``
distance matrix of the XLA path (an element budget, from which the chunk
follows the grid size), or — where the fused BMU kernel never writes that
matrix — giving the kernel enough row blocks to fill the card.
"""

from __future__ import annotations

import os

import jax

__all__ = [
    "find_cpu_cores",
    "default_n_parallel",
    "backend_kind",
    "round_up",
    "training_chunk",
    "inference_chunk",
    "ROW_BLOCK",
]

# Inference chunk-size ladder: geometric rungs (×8) bound the set of
# compiled shapes across arbitrary call sizes — see inference_chunk.
INFER_RUNGS = (8, 64, 512)

# Chunks above one row block are whole multiples of it: the largest row
# block (BN) of the fused BMU kernel (ops.pallas.bmu), so no chunk pads.
ROW_BLOCK = 128

# Distance-matrix element budget per chunk. 2^24 fp32 elements = 64 MB
# transient on accelerators; scaled down on CPU hosts.
_ACCEL_BUDGET = 1 << 24
_CPU_BUDGET = 1 << 20

# Rows per chunk when the fused kernel runs the search: 16384 rows are
# 256 row blocks of 64, about two per SM of an H100 (PERF.md).
_FUSED_CHUNK = 16384


def find_cpu_cores() -> int:
    """Number of host CPU cores (reference utils.py:15-20)."""
    return os.cpu_count() or 1


def backend_kind() -> str:
    """'gpu' or 'cpu' for the default JAX backend."""
    return jax.default_backend()


def round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


def _align_cap(cap: int) -> int:
    """Round a chunk budget DOWN to whole row blocks above one block, and
    to 8 rows above 8; a cap below 8 (an explicit user budget) stands."""
    if cap > ROW_BLOCK:
        return (cap // ROW_BLOCK) * ROW_BLOCK
    if cap >= 8:
        return (cap // 8) * 8
    return cap


def training_chunk(n: int, n_parallel: int) -> int:
    """THE training-branch chunk size: budget cap, shrunk to the data,
    whole row blocks above one block. Rounds DOWN so ``n_parallel`` (a
    memory budget, reference xpysom.py:131-137) is never exceeded.
    Shared by ``XPySom._chunked`` and ``SomPopulation._train_serial`` so
    the serial sweep's 'bit-identical to training each member
    individually' guarantee can never drift."""
    chunk = min(n_parallel, round_up(max(n, 1), 8))
    if chunk > ROW_BLOCK:
        chunk = (chunk // ROW_BLOCK) * ROW_BLOCK
    return chunk


def inference_chunk(n: int, cap: int) -> tuple[int, int]:
    """THE inference-branch (bucketed) chunk sizing: snap the padded shape
    onto a small ladder so repeated calls with varying batch sizes reuse
    executables instead of retracing per distinct length. Returns
    ``(chunk, min_chunks)`` for ``chunk_data``: the chunk rounds up to the
    next ``INFER_RUNGS`` rung under the budget cap (then the cap), and the
    chunk COUNT rounds up to a power of two with fully-masked padding
    chunks — distinct compiled shapes across ANY call sequence ≤
    len(rungs)+1 ladder × log₂(max C). The cap rounds DOWN to its
    alignment (``_align_cap``), so a user-specified ``n_parallel`` (a
    memory budget, reference xpysom.py:131-137) is never exceeded.
    Shared by ``XPySom._chunked(bucket=True)`` and the streaming
    ``SomPopulation`` metrics so the compile-class bound can never drift
    between them."""
    cap = _align_cap(cap)
    chunk = next((r for r in INFER_RUNGS if n <= r <= cap), cap)
    c = max(1, -(-n // chunk))
    return chunk, 1 << (c - 1).bit_length()


def default_n_parallel(
    xy: int, backend: str | None = None, fused: bool = False
) -> int:
    """Auto-size the mini-batch (samples per chunk) like the reference's
    ``n_parallel`` default (xpysom.py:242-251), budgeted against the
    transient ``(chunk, XY)`` distance matrix instead of CUDA thread
    residency. Clamped to [256, 65536] and rounded to a multiple of 256.

    ``fused=True`` (the fused BMU kernel runs the search, on the GPU):
    no distance matrix is written, so the budget does not apply; the
    chunk is ``_FUSED_CHUNK`` rows."""
    backend = backend or backend_kind()
    if fused and backend == "gpu":
        return _FUSED_CHUNK
    budget = _ACCEL_BUDGET if backend == "gpu" else _CPU_BUDGET
    chunk = budget // max(xy, 1)
    # round DOWN to the 256 multiple (floor 256): rounding up after the
    # division could exceed the element budget by ~2x at awkward XY
    chunk = max(256, min(65536, (chunk // 256) * 256))
    return chunk
