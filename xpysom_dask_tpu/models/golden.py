"""NumPy golden model: the parity oracle for the JAX build.

The reference test-suite uses MiniSom as numerical ground truth
(reference tests.py:12,25,161-246). MiniSom is not vendorable here, so this
module is an independent, deliberately *naive* NumPy implementation of the
same math, written the way the reference computes it (materialized
``(N, X, Y)`` neighborhood tensor, ``gᵀ@x`` GEMM update — xpysom.py:420-443)
— NOT the way the JAX core computes it (per-BMU sufficient statistics,
factored neighborhood operator). Agreement between the two paths is
therefore a real cross-check of the redesign, not a tautology.

Formulas (with their reference citations):

- partial squared euclidean ``-2 x·w + ‖w‖²`` (distances.py:11-23)
- gaussian ``exp(-(n-c)²/d)`` outer product, ``d = 2·std_coeff²·σ²``
  (neighborhoods.py:14-33)
- mexican hat ``exp(-p/d)(1 - 2p/d)`` (neighborhoods.py:57-74)
- bubble strict box (neighborhoods.py:99-112), triangle clamped ramp
  (neighborhoods.py:114-130)
- batch update ``W' = where(den ≠ 0, num/den, W)`` (xpysom.py:446-455)
- decays (decays.py:4-65)
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "golden_distance",
    "golden_neighborhood",
    "golden_decay",
    "GoldenSom",
]


def golden_distance(name, x, w_flat, p=2):
    """(N, XY) distance matrix, scalar-math definition per pair."""
    x = np.asarray(x, dtype=np.float64)
    w = np.asarray(w_flat, dtype=np.float64)
    diff = x[:, None, :] - w[None, :, :]
    if name == "euclidean":
        return -2.0 * (x @ w.T) + np.sum(w**2, axis=1)[None, :]
    if name == "euclidean_no_opt":
        return np.sum(diff**2, axis=2)
    if name == "euclidean_full":
        return np.sqrt(np.sum(diff**2, axis=2))
    if name == "cosine":
        nx = np.linalg.norm(x, axis=1, keepdims=True)
        nw = np.linalg.norm(w, axis=1, keepdims=True)
        with np.errstate(divide="ignore", invalid="ignore"):
            sim = np.nan_to_num((x @ w.T) / (nx * nw.T))
        return 1.0 - sim
    if name in ("manhattan", "manhattan_no_opt"):
        return np.sum(np.abs(diff), axis=2)
    if name in ("norm_p", "norm_p_no_opt"):
        return np.sum(np.abs(diff) ** p, axis=2)
    raise ValueError(name)


def _grid(x, y, topology):
    xx, yy = np.meshgrid(np.arange(x), np.arange(y))
    xx = xx.astype(np.float64)
    yy = yy.astype(np.float64)
    if topology == "hexagonal":
        xx[::-2] -= 0.5
    return xx, yy


def golden_neighborhood(
    name, x, y, c, sigma, std_coeff=0.5, compact_support=False, topology="rectangular"
):
    """(N, X, Y) neighborhood weights centered at integer BMU coords
    ``c = (cx, cy)``, scalar-math definition."""
    cx = np.asarray(c[0], dtype=np.float64)
    cy = np.asarray(c[1], dtype=np.float64)
    n = len(cx)
    out = np.zeros((n, x, y))
    d = 2.0 * std_coeff**2 * sigma**2

    if topology == "rectangular" or name in ("bubble", "triangle"):
        # NB: the reference keeps bubble (and triangle) on the *integer*
        # grid even under hexagonal topology (xpysom.py:277-278 passes
        # _neigx/_neigy, not the offset coordinate meshes).
        gx = np.arange(x, dtype=np.float64)
        gy = np.arange(y, dtype=np.float64)
        coord_x = np.broadcast_to(gx[:, None], (x, y))
        coord_y = np.broadcast_to(gy[None, :], (x, y))
        cxs, cys = cx, cy
    else:
        xx, yy = _grid(x, y, topology)
        coord_x = xx.T  # (x, y)
        coord_y = yy.T
        cxs = coord_x[c[0].astype(int), c[1].astype(int)]
        cys = coord_y[c[0].astype(int), c[1].astype(int)]

    for i in range(n):
        px = (coord_x - cxs[i]) ** 2
        py = (coord_y - cys[i]) ** 2
        in_x = np.logical_and(coord_x > cxs[i] - sigma, coord_x < cxs[i] + sigma)
        in_y = np.logical_and(coord_y > cys[i] - sigma, coord_y < cys[i] + sigma)
        if name == "gaussian":
            ax = np.exp(-px / d)
            ay = np.exp(-py / d)
            if compact_support:
                ax = ax * in_x
                ay = ay * in_y
            out[i] = ax * ay
        elif name == "mexican_hat":
            if compact_support:
                px = px * in_x
                py = py * in_y
            p = px + py
            out[i] = np.exp(-p / d) * (1 - 2 / d * p)
        elif name == "bubble":
            out[i] = (in_x & in_y).astype(np.float64)
        elif name == "triangle":
            tx = np.maximum(sigma - np.abs(cxs[i] - coord_x), 0.0)
            ty = np.maximum(sigma - np.abs(cys[i] - coord_y), 0.0)
            if compact_support:
                tx = tx * in_x
                ty = ty * in_y
            out[i] = tx * ty
        else:
            raise ValueError(name)
    return out


def golden_decay(name, val0, valN, t, T):
    if name == "asymptotic":
        return val0 / (1 + 2 * t / T)
    if name == "exponential":
        if valN == 0:
            diff = -math.log(0.1) / T
        else:
            diff = -math.log(valN / val0) / T
        return val0 * math.exp(-t * diff)
    if name == "linear":
        if T != 1:
            return val0 + (valN - val0) * t / (T - 1)
        return val0
    raise ValueError(name)


class GoldenSom:
    """Naive NumPy batch SOM following the reference algorithm structure
    (chunked epoch loop, materialized g, gᵀ@x numerator — xpysom.py:515-577)."""

    def __init__(
        self,
        x,
        y,
        input_len,
        sigma=0,
        sigmaN=1,
        learning_rate=0.5,
        learning_rateN=0.01,
        decay="exponential",
        neighborhood="gaussian",
        std_coeff=0.5,
        topology="rectangular",
        compact_support=False,
        random_seed=None,
        distance="euclidean",
        distance_kwargs=None,
    ):
        self.x, self.y, self.input_len = x, y, input_len
        self.distance = distance
        self.distance_kwargs = dict(distance_kwargs or {})
        self.sigma = min(x, y) / 2 if sigma == 0 else sigma
        self.sigmaN = sigmaN
        self.lr0, self.lrN = learning_rate, learning_rateN
        self.decay = decay
        self.neighborhood = neighborhood
        self.std_coeff = std_coeff
        self.topology = topology
        self.compact_support = compact_support
        rng = np.random.RandomState(random_seed)
        self.weights = rng.rand(x, y, input_len) * 2 - 1
        self.weights /= np.linalg.norm(self.weights, axis=-1, keepdims=True)

    def bmu(self, data):
        w_flat = self.weights.reshape(-1, self.input_len)
        d = golden_distance(
            self.distance, data, w_flat, **self.distance_kwargs
        )
        return np.argmin(d, axis=1)

    def train(self, data, num_epochs, iter_beg=0, iter_end=None):
        data = np.asarray(data, dtype=np.float32)
        if iter_end is None:
            iter_end = num_epochs
        w = self.weights.astype(np.float32)
        for t in range(iter_beg, iter_end):
            eta = golden_decay(self.decay, self.lr0, self.lrN, t, num_epochs)
            sig = golden_decay(self.decay, self.sigma, self.sigmaN, t, num_epochs)
            w_flat = w.reshape(-1, self.input_len)
            d = golden_distance(
                self.distance, data, w_flat, **self.distance_kwargs
            )
            flat_bmu = np.argmin(d, axis=1)
            c = (flat_bmu // self.y, flat_bmu % self.y)
            # Known residual divergence vs XLA implementations: when the
            # neighborhood underflows (exp arguments < -88), XLA flushes
            # f32 subnormals to zero (den == 0 -> keep weight) while NumPy
            # keeps them (den ~ 1e-40 -> fill with num/den of noise).
            # Both fills are meaningless; avoid sigma*std_coeff << 1 when
            # comparing implementations.
            # The reference computes g in float32 (neighborhoods.py:26-27
            # power(..., dtype=float32); accumulators are float32,
            # xpysom.py:520-527). Keeping g in float64 here would preserve
            # sub-f32 underflow values (e.g. exp(-x) ~ 1e-100 for tiny σ)
            # and flip the den != 0 merge branch relative to every f32
            # implementation, including the reference itself.
            g = (
                golden_neighborhood(
                    self.neighborhood,
                    self.x,
                    self.y,
                    c,
                    sig,
                    self.std_coeff,
                    self.compact_support,
                    self.topology,
                )
                * eta
            ).astype(np.float32)
            den = g.sum(axis=0)[:, :, None]
            g_flat = g.reshape(g.shape[0], -1)
            num = (g_flat.T @ data).reshape(w.shape)
            w = np.where(den != 0, num / den, w).astype(np.float32)
        self.weights = w
        return self

    def quantization_error(self, data):
        # BMU by EUCLIDEAN distance regardless of the activation distance,
        # like the reference (xpysom.py:632-645,673-707)
        data = np.asarray(data, dtype=np.float64)
        w_flat = self.weights.reshape(-1, self.input_len)
        bmu = np.argmin(golden_distance("euclidean", data, w_flat), axis=1)
        return float(np.mean(np.linalg.norm(data - w_flat[bmu], axis=1)))
