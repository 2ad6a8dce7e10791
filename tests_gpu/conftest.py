"""On-card test configuration.

Unlike ``tests/`` (which forces an 8-virtual-device CPU platform so the
suite runs anywhere), this directory runs against the default JAX backend:
the fused kernels compiled for the card, checked against float64 NumPy
references and the golden model (``models/golden.py``). Every test is
marked ``gpu``; off the GPU each one skips from the fixture below.

Run from the repository root on a machine with a GPU:

    python -m pytest tests_gpu -q -m gpu

``chip_smoke.py`` runs this suite in its own process (phase 5).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests when JAX's default backend is not a GPU
    (decided here, at run time — never at import or collection)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        pytest.skip(f"needs a GPU backend (JAX default backend: {backend})")
