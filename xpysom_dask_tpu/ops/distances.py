"""Pairwise sample-to-codebook distance kernels.

JAX rebuild of the reference distance module
(``xpysom_dask/distances.py``). The reference threads a NumPy/CuPy ``xp``
module through every function; here each distance is a pure jittable JAX
function, and these functions are the XLA reference path. Dense forms are
expressed as matmuls. The one native CUDA kernel in the reference (the
Manhattan ``ReductionKernel``, distances.py:110-118) needs no counterpart:
XLA fuses the broadcast ``abs``-reduce form into one reduction. The fused
euclidean/cosine BMU search on the GPU is ``ops.pallas.bmu``.

All functions take ``x`` of shape ``(N, D)`` and a flattened codebook ``w``
of shape ``(XY, D)`` and return a ``(N, XY)`` distance matrix. An optional
precomputed ``w_sq = sum(w**2, axis=1, keepdims=True)`` of shape ``(XY, 1)``
may be passed for the distances whose dispatcher entry is cacheable
(``can_cache``, reference distances.py:179-182).

Semantics preserved:

- ``'euclidean'`` maps to the *partial* squared L2 ``-2 x@Wᵀ + ‖w‖²``; the
  ``‖x‖²`` term is dropped because it is constant per row and argmin-
  invariant (reference distances.py:11-23,163).
- ``norm_p`` uses the binomial-expansion GEMM trick for even ``p``
  (reference distances.py:77-96): every term is a GEMM.
- ``euclidean_distance`` wraps the squared form in ``nan_to_num`` + ``sqrt``
  (negative values from fp cancellation clamp to 0 before the sqrt).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# Distance matmuls run at HIGHEST precision: the BMU argmin is sensitive to
# reduced-precision matmul defaults (bf16, or TF32 on the GPU, flip
# near-tied winners), and this is the exact reference path.
_PRECISION = jax.lax.Precision.HIGHEST

__all__ = [
    "euclidean_squared_distance_part",
    "euclidean_squared_distance",
    "euclidean_distance",
    "cosine_distance",
    "norm_p_power_distance_generic",
    "norm_p_power_distance_even",
    "norm_p_power_distance",
    "manhattan_distance",
    "manhattan_distance_no_opt",
    "DistanceFunction",
    "DISTANCE_NAMES",
]

_F32 = jnp.float32


def _w_sq(w):
    return jnp.sum(jnp.square(w), axis=1, keepdims=True)


def euclidean_squared_distance_part(x, w, w_sq=None):
    """Partial squared L2: ``-2 x@Wᵀ + ‖w‖²`` (argmin-equivalent to the
    full squared distance; reference distances.py:11-23)."""
    if w_sq is None:
        w_sq = _w_sq(w)
    cross = jnp.dot(x, w.T, preferred_element_type=_F32, precision=_PRECISION)
    return -2.0 * cross + w_sq.T


def euclidean_squared_distance(x, w, w_sq=None):
    """Full squared L2 distance (reference distances.py:25-31)."""
    x_sq = jnp.sum(jnp.square(x), axis=1, keepdims=True)
    return euclidean_squared_distance_part(x, w, w_sq) + x_sq


def euclidean_distance(x, w, w_sq=None):
    """L2 distance. Clamps tiny negative fp-cancellation residues to zero
    before the sqrt (the reference does this via nan_to_num *after* the
    sqrt, distances.py:38-43; clamping first is equivalent and avoids
    producing the NaNs at all)."""
    d2 = euclidean_squared_distance(x, w, w_sq)
    return jnp.sqrt(jnp.maximum(d2, 0.0))


def cosine_distance(x, w, w_sq=None):
    """Cosine distance ``1 - x·w / (‖x‖‖w‖)`` with nan_to_num on the
    similarity like the reference (distances.py:45-59)."""
    if w_sq is None:
        w_sq = _w_sq(w)
    x_sq = jnp.sum(jnp.square(x), axis=1, keepdims=True)
    num = jnp.dot(x, w.T, preferred_element_type=_F32, precision=_PRECISION)
    denum = jnp.sqrt(x_sq * w_sq.T)
    similarity = jnp.nan_to_num(num / denum)
    return 1.0 - similarity


def norm_p_power_distance_generic(x, w, p=2):
    """``sum(|x - w|**p)`` via explicit broadcast (reference
    distances.py:61-75). O(N·XY·D) VPU work — the slow generic path."""
    return jnp.sum(
        jnp.power(jnp.abs(x[:, None, :] - w[None, :, :]), p), axis=2
    )


def norm_p_power_distance_even(x, w, p=2):
    """Binomial-expansion GEMM form of ``sum((x - w)**p)`` for even ``p``
    (reference distances.py:77-96): ``sum_e (-1)^e C(p,e) (x^(p-e))·(w^e)ᵀ``.
    Every term is a GEMM."""
    if p % 2 != 0:
        raise ValueError("p must be even")
    if p < 2:
        # the expansion's range(p + 1) loop is empty for negative p (an
        # all-zeros "distance" — silently wrong argmins); the dispatcher
        # keeps p < 2 on the generic pow path, and a direct caller gets a
        # real error
        raise ValueError("p must be even and >= 2")
    # a float integral p (e.g. 2.0) selects this branch via `p % 2 == 0`
    # — coerce so range(p + 1) works
    p = int(p)
    acc = jnp.zeros((x.shape[0], w.shape[0]), dtype=_F32)
    k = 1
    for e in range(p + 1):
        sign = -1.0 if e % 2 == 1 else 1.0
        acc = acc + sign * k * jnp.dot(
            x ** (p - e), (w**e).T, preferred_element_type=_F32,
            precision=_PRECISION,
        )
        k = (k * (p - e)) // (e + 1)
    return acc


def norm_p_power_distance(x, w, p=2):
    """Norm-p distance raised to the p-th power, choosing the GEMM form for
    even p (reference distances.py:98-107). Zero/negative p stay on the
    generic pow path — the binomial expansion only exists for p >= 2
    (for p=-2, ``-2 % 2 == 0`` would otherwise select an empty-loop
    expansion returning all zeros)."""
    if p % 2 == 0 and p >= 2:
        return norm_p_power_distance_even(x, w, p)
    return norm_p_power_distance_generic(x, w, p)


def manhattan_distance_no_opt(x, w):
    """Broadcast-form Manhattan distance (reference distances.py:137-144)."""
    return jnp.sum(jnp.abs(x[:, None, :] - w[None, :, :]), axis=2)


def manhattan_distance(x, w):
    """Manhattan distance: the broadcast ``abs``-reduce form, which XLA
    fuses into one reduction — what the reference's CUDA
    ``ReductionKernel`` (distances.py:110-135) was written by hand for."""
    return manhattan_distance_no_opt(x, w)


# Name registry mirroring the reference dispatcher (distances.py:162-170).
_DISTANCE_FUNCTIONS = {
    "euclidean": euclidean_squared_distance_part,
    "euclidean_no_opt": euclidean_squared_distance,
    "manhattan": manhattan_distance,
    "manhattan_no_opt": manhattan_distance_no_opt,
    "cosine": cosine_distance,
    "norm_p": norm_p_power_distance,
    "norm_p_no_opt": norm_p_power_distance_generic,
}

DISTANCE_NAMES = tuple(_DISTANCE_FUNCTIONS)

# Distances that accept a precomputed ‖w‖² (reference distances.py:179-182).
_CACHEABLE = frozenset({"euclidean", "cosine"})
# Distances whose signature accepts w_sq at all.
_TAKES_WSQ = frozenset({"euclidean", "euclidean_no_opt", "cosine"})


class DistanceFunction:
    """Name → distance-kernel dispatcher (reference distances.py:160-191).

    ``__call__`` accepts the codebook in its natural ``(X, Y, D)`` shape and
    flattens it to ``(X·Y, D)``; an optional cached ``w_flat_sq`` is
    forwarded for cacheable distances.
    """

    def __init__(self, name, kwargs=None):
        if name not in _DISTANCE_FUNCTIONS:
            raise ValueError(
                "%s not supported. Distances available: %s"
                % (name, ", ".join(_DISTANCE_FUNCTIONS.keys()))
            )
        self.name = name
        self.kwargs = dict(kwargs or {})
        self.can_cache = name in _CACHEABLE
        self._fn = _DISTANCE_FUNCTIONS[name]

    def flat(self, x, w_flat, w_flat_sq=None):
        """Apply to an already-flattened ``(XY, D)`` codebook."""
        if w_flat_sq is not None and self.name in _TAKES_WSQ:
            return self._fn(x, w_flat, w_flat_sq, **self.kwargs)
        return self._fn(x, w_flat, **self.kwargs)

    def __call__(self, x, w, w_flat_sq=None):
        w_flat = w.reshape(-1, w.shape[2])
        return self.flat(x, w_flat, w_flat_sq)
