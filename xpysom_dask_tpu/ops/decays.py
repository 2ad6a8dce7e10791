"""Decay schedules for learning rate and neighborhood radius.

JAX rebuild of the reference schedules (reference:
``xpysom_dask/decays.py:4-65``). Each schedule is a pure function of the
iteration index and is fully jittable: the iteration ``t`` may be a traced
JAX scalar so a single compiled epoch step serves every epoch of a training
run. ``max_iter`` is treated as a static Python int (it fixes the schedule,
not the data).

Semantics preserved from the reference:

- ``asymptotic``: ``v0 / (1 + 2 t / T)`` — ignores ``valN``
  (decays.py:20).
- ``exponential``: ``v0 * exp(-t * k)`` with ``k = -ln(vN / v0) / T``; when
  ``vN == 0`` the reference substitutes ``k = -ln(0.1) / T``
  (decays.py:39-43).
- ``linear``: lerp over ``T - 1`` steps; returns ``v0`` when ``T == 1``
  (decays.py:62-65).
"""

from __future__ import annotations

import math

import jax.numpy as jnp

__all__ = [
    "asymptotic_decay",
    "exponential_decay",
    "linear_decay",
    "DECAY_REGISTRY",
    "make_decay",
]


def asymptotic_decay(val0, valN, curr_iter, max_iter):
    """``val0 / (1 + 2 t / T)``. ``valN`` is ignored (asymptotic)."""
    del valN
    return val0 / (1.0 + 2.0 * curr_iter / max_iter)


def exponential_decay(val0, valN, curr_iter, max_iter):
    """``val0 * exp(-t * k)`` with ``k = -ln(valN/val0)/T`` (or ``-ln(0.1)/T``
    when ``valN == 0``, matching the reference's special case)."""
    if valN == 0:
        diff = -math.log(0.1) / max_iter
    else:
        diff = -math.log(valN / val0) / max_iter
    return val0 * jnp.exp(-curr_iter * diff)


def linear_decay(val0, valN, curr_iter, max_iter):
    """Linear interpolation from ``val0`` (t=0) to ``valN`` (t=T-1)."""
    if max_iter != 1:
        return val0 + (valN - val0) * curr_iter / (max_iter - 1)
    return val0 * jnp.ones_like(jnp.asarray(curr_iter, dtype=jnp.float32))


DECAY_REGISTRY = {
    "exponential": exponential_decay,
    "asymptotic": asymptotic_decay,
    "linear": linear_decay,
}


def make_decay(name: str):
    """Resolve a decay schedule by name, raising ValueError like the
    reference constructor does (xpysom.py:217-220)."""
    if name not in DECAY_REGISTRY:
        raise ValueError(
            "%s not supported. Functions available: %s"
            % (name, ", ".join(DECAY_REGISTRY.keys()))
        )
    return DECAY_REGISTRY[name]
