"""xpysom_dask_tpu — batch Self-Organizing Maps in JAX.

A from-scratch rebuild of XPySom-Dask (jcfaracco/xpysom-dask): the
NumPy/CuPy ``xp`` backend becomes a jitted JAX/XLA functional core with a
fused Pallas BMU kernel on the GPU hot path, and Dask data-parallelism
becomes ``shard_map`` over a ``jax.sharding.Mesh`` with ``psum``
reductions.

Public surface mirrors the reference package root (``__init__.py:1``):
``XPySom`` is the headline export; the ops/parallel/utils layers are
importable as submodules.
"""

from .models.population import SomPopulation
from .models.som import XPySom

__version__ = "0.1.0"

__all__ = ["XPySom", "SomPopulation", "__version__"]
