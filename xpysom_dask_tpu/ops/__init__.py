"""Numeric kernels: distances, neighborhoods, decay schedules, the
Pallas BMU kernel. The jit-compiled counterpart of the reference's L1 layer
(``distances.py``/``neighborhoods.py``/``decays.py``)."""

from . import decays, distances, neighborhoods

__all__ = ["decays", "distances", "neighborhoods"]
