"""Neighborhood weight kernels.

JAX rebuild of ``xpysom_dask/neighborhoods.py``. Two forms are
provided:

1. **Batched per-center form** (API- and numerics-parity with the
   reference): ``f(..., c, sigma) -> (N, X, Y)`` where ``c = (cx, cy)`` are
   integer BMU coordinates per sample. These match the reference functions
   element-for-element and back the parity test-suite.

2. **Operator (factorized) form** for the training update: the
   batch-SOM numerator ``Σₙ h(bmu_n)·x_n`` only depends on samples through
   the per-BMU sufficient statistics ``S[b] = Σ_{n: bmu=b} x_n``, so the
   neighborhood enters as a *fixed per-epoch linear operator* ``H[b, j]``
   over grid nodes. For rectangular topologies every reference kernel is a
   (sum of) separable product(s) ``H = Σ_k Axᵏ ⊗ Ayᵏ`` with tiny
   ``(X, X)``/``(Y, Y)`` factors, turning the update into two small
   GEMMs instead of the reference's ``(X·Y, N) @ (N, D)`` GEMM over a
   materialized ``(N, X, Y)`` tensor (reference xpysom.py:434-440). The
   hexagonal (generic) kernels factor the same way once split by the
   offset-row parity classes (Δx is half-integer across classes, integer
   within): three class-masked separable terms for gaussian, nine for
   mexican hat — hex trains at rectangular speed.

Semantics preserved from the reference:

- gaussian denominator ``d = 2·std_coeff²·σ²`` (neighborhoods.py:19).
- ``compact_support`` multiplies by the *strict* box ``c-σ < n < c+σ``
  (neighborhoods.py:29-31).
- mexican hat ``exp(-p/d)·(1 - 2p/d)`` (neighborhoods.py:74).
- bubble is the strict boolean box cast to float32 (neighborhoods.py:108-112).
- triangle is ``max(σ - |c - n|, 0)`` per axis (neighborhoods.py:121-124).
- generic (hex) kernels gather center coordinates as ``xx.T[c]`` and
  transpose the output to ``(N, X, Y)`` (neighborhoods.py:45-46,55).

Documented deviation: the reference's ``compact_support`` branch in the
mexican-hat kernels multiplies *both* axis masks into ``px``
(neighborhoods.py:69-71,91-93), which only broadcasts when ``X == Y`` and
leaves ``py`` unmasked — a latent bug. We implement the evident intent
(``px`` masked along x, ``py`` masked along y). Note this differs from the
reference even on square grids whenever any mask entry is 0 (the reference
double-masks ``px`` and never masks ``py``); the outputs coincide exactly
only when the box masks are all-ones, i.e. σ spans the whole grid. See
PARITY.md ("mexican hat + compact_support").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Operator-application GEMMs run at HIGHEST precision: they are tiny
# (O(XY^2 D) worst case) but feed the codebook update directly, and a
# bf16 or TF32 matmul default would inject ~1e-3 relative error into W.
_PRECISION = jax.lax.Precision.HIGHEST

__all__ = [
    "prepare_neig_func",
    "gaussian_rect",
    "gaussian_generic",
    "mexican_hat_rect",
    "mexican_hat_generic",
    "bubble",
    "triangle",
    "NEIGHBORHOOD_NAMES",
    "neighborhood_operator",
]

NEIGHBORHOOD_NAMES = ("gaussian", "mexican_hat", "bubble", "triangle")

_F32 = jnp.float32


def prepare_neig_func(func, *first_args):
    """Partial application helper (reference neighborhoods.py:9-12)."""

    def _inner(*args, **kwargs):
        return func(*first_args, *args, **kwargs)

    return _inner


def _box_mask(n, c, sigma):
    """Strict open box ``c - σ < n < c + σ`` as float32."""
    return (jnp.logical_and(n > c - sigma, n < c + sigma)).astype(_F32)


# ---------------------------------------------------------------------------
# Batched per-center kernels (parity with the reference)
# ---------------------------------------------------------------------------


def gaussian_rect(neigx, neigy, std_coeff, compact_support, c, sigma):
    """Gaussian centered at ``c`` on a rectangular grid: separable outer
    product of 1-D gaussians (reference neighborhoods.py:14-33)."""
    d = 2.0 * std_coeff**2 * sigma**2
    nx = neigx[None, :].astype(_F32)
    ny = neigy[None, :].astype(_F32)
    cx = c[0][:, None].astype(_F32)
    cy = c[1][:, None].astype(_F32)

    ax = jnp.exp(-jnp.square(nx - cx) / d)
    ay = jnp.exp(-jnp.square(ny - cy) / d)

    if compact_support:
        ax = ax * _box_mask(nx, cx, sigma)
        ay = ay * _box_mask(ny, cy, sigma)

    return ax[:, :, None] * ay[:, None, :]


def gaussian_generic(xx, yy, std_coeff, compact_support, c, sigma):
    """Gaussian centered at ``c`` on any topology via euclidean grid
    coordinates (reference neighborhoods.py:35-55). ``xx``/``yy`` have shape
    ``(Y, X)`` (meshgrid 'xy' indexing); centers gather from the transpose."""
    d = 2.0 * std_coeff**2 * sigma**2
    nx = xx[None, :, :].astype(_F32)
    ny = yy[None, :, :].astype(_F32)
    cx = xx.T[c[0], c[1]][:, None, None].astype(_F32)
    cy = yy.T[c[0], c[1]][:, None, None].astype(_F32)

    ax = jnp.exp(-jnp.square(nx - cx) / d)
    ay = jnp.exp(-jnp.square(ny - cy) / d)

    if compact_support:
        ax = ax * _box_mask(nx, cx, sigma)
        ay = ay * _box_mask(ny, cy, sigma)

    return (ax * ay).transpose((0, 2, 1))


def mexican_hat_rect(neigx, neigy, std_coeff, compact_support, c, sigma):
    """Mexican hat on a rectangular grid (reference neighborhoods.py:57-74)."""
    d = 2.0 * std_coeff**2 * sigma**2
    nx = neigx[None, :].astype(_F32)
    ny = neigy[None, :].astype(_F32)
    cx = c[0][:, None].astype(_F32)
    cy = c[1][:, None].astype(_F32)

    px = jnp.square(nx - cx)
    py = jnp.square(ny - cy)

    if compact_support:
        # Intended semantics of reference neighborhoods.py:69-71 (see module
        # docstring): mask each axis' squared distance inside its own box.
        px = px * _box_mask(nx, cx, sigma)
        py = py * _box_mask(ny, cy, sigma)

    p = px[:, :, None] + py[:, None, :]
    return jnp.exp(-p / d) * (1.0 - 2.0 / d * p)


def mexican_hat_generic(xx, yy, std_coeff, compact_support, c, sigma):
    """Mexican hat on any topology (reference neighborhoods.py:76-97)."""
    d = 2.0 * std_coeff**2 * sigma**2
    nx = xx[None, :, :].astype(_F32)
    ny = yy[None, :, :].astype(_F32)
    cx = xx.T[c[0], c[1]][:, None, None].astype(_F32)
    cy = yy.T[c[0], c[1]][:, None, None].astype(_F32)

    px = jnp.square(nx - cx)
    py = jnp.square(ny - cy)

    if compact_support:
        px = px * _box_mask(nx, cx, sigma)
        py = py * _box_mask(ny, cy, sigma)

    p = px + py
    return (jnp.exp(-p / d) * (1.0 - 2.0 / d * p)).transpose((0, 2, 1))


def bubble(neigx, neigy, c, sigma):
    """Constant (boolean box) neighborhood (reference neighborhoods.py:99-112)."""
    nx = neigx[None, :].astype(_F32)
    ny = neigy[None, :].astype(_F32)
    cx = c[0][:, None].astype(_F32)
    cy = c[1][:, None].astype(_F32)
    ax = _box_mask(nx, cx, sigma)
    ay = _box_mask(ny, cy, sigma)
    return ax[:, :, None] * ay[:, None, :]


def triangle(neigx, neigy, compact_support, c, sigma):
    """Triangular neighborhood (reference neighborhoods.py:114-130)."""
    nx = neigx[None, :].astype(_F32)
    ny = neigy[None, :].astype(_F32)
    cx = c[0][:, None].astype(_F32)
    cy = c[1][:, None].astype(_F32)

    tx = jnp.maximum(sigma - jnp.abs(cx - nx), 0.0)
    ty = jnp.maximum(sigma - jnp.abs(cy - ny), 0.0)

    if compact_support:
        tx = tx * _box_mask(nx, cx, sigma)
        ty = ty * _box_mask(ny, cy, sigma)

    return tx[:, :, None] * ty[:, None, :]


# ---------------------------------------------------------------------------
# Operator (factorized) form for the scatter-based training update
# ---------------------------------------------------------------------------


def _axis_factors_gaussian(n1d, std_coeff, compact_support, sigma):
    """(K, K) matrix A[c, i] = exp(-(i-c)²/d) [· box mask] along one axis."""
    d = 2.0 * std_coeff**2 * sigma**2
    n = n1d[None, :].astype(_F32)
    c = n1d[:, None].astype(_F32)
    a = jnp.exp(-jnp.square(n - c) / d)
    if compact_support:
        a = a * _box_mask(n, c, sigma)
    return a


def neighborhood_operator(
    name,
    topology,
    neigx,
    neigy,
    xx,
    yy,
    std_coeff,
    compact_support,
    sigma,
):
    """Return the per-epoch neighborhood operator in its cheapest form.

    The training update applies ``num[j] = Σ_b H[b, j]·S[b]`` where ``b``
    ranges over grid nodes acting as BMU centers. Returns
    ``("sum_separable", [(Ax, Ay), ...])`` — ``H = Σ_k Axᵏ ⊗ Ayᵏ`` with
    ``Ax: (X, X)``, ``Ay: (Y, Y)``; the update is two small GEMMs per
    term. Every supported kernel factors this way: rectangular kernels
    directly, hexagonal gaussian/mexican-hat after splitting by the
    offset-row parity classes (see the hexagonal branch below).

    ``sigma`` may be traced; ``name``/``topology``/``compact_support`` are
    static.
    """
    X = int(neigx.shape[0])
    Y = int(neigy.shape[0])

    if topology == "rectangular":
        if name == "gaussian":
            ax = _axis_factors_gaussian(neigx, std_coeff, compact_support, sigma)
            ay = _axis_factors_gaussian(neigy, std_coeff, compact_support, sigma)
            return ("sum_separable", [(ax, ay)])
        if name == "bubble":
            nx = neigx[None, :].astype(_F32)
            ny = neigy[None, :].astype(_F32)
            ax = _box_mask(nx, neigx[:, None].astype(_F32), sigma)
            ay = _box_mask(ny, neigy[:, None].astype(_F32), sigma)
            return ("sum_separable", [(ax, ay)])
        if name == "triangle":
            nx = neigx[None, :].astype(_F32)
            cx = neigx[:, None].astype(_F32)
            ny = neigy[None, :].astype(_F32)
            cy = neigy[:, None].astype(_F32)
            ax = jnp.maximum(sigma - jnp.abs(cx - nx), 0.0)
            ay = jnp.maximum(sigma - jnp.abs(cy - ny), 0.0)
            if compact_support:
                ax = ax * _box_mask(nx, cx, sigma)
                ay = ay * _box_mask(ny, cy, sigma)
            return ("sum_separable", [(ax, ay)])
        if name == "mexican_hat":
            # H = Ex⊗Ey · (1 - u - v) with u = 2px/d, v = 2py/d
            #   = Ex⊗Ey - (Ex·u)⊗Ey - Ex⊗(Ey·v): a rank-3 separable sum.
            d = 2.0 * std_coeff**2 * sigma**2
            nx = neigx[None, :].astype(_F32)
            cx = neigx[:, None].astype(_F32)
            ny = neigy[None, :].astype(_F32)
            cy = neigy[:, None].astype(_F32)
            px = jnp.square(nx - cx)
            py = jnp.square(ny - cy)
            if compact_support:
                px = px * _box_mask(nx, cx, sigma)
                py = py * _box_mask(ny, cy, sigma)
            ex = jnp.exp(-px / d)
            ey = jnp.exp(-py / d)
            u = 2.0 / d * px
            v = 2.0 / d * py
            return (
                "sum_separable",
                [(ex, ey), (-ex * u, ey), (ex, -ey * v)],
            )
        raise ValueError(f"unknown neighborhood {name!r}")

    if topology == "hexagonal":
        if name == "bubble":
            # the reference keeps bubble on the *integer* grid under hex
            # topology (xpysom.py:277-278) — identical to the rect factors
            nx = neigx[None, :].astype(_F32)
            ny = neigy[None, :].astype(_F32)
            ax = _box_mask(nx, neigx[:, None].astype(_F32), sigma)
            ay = _box_mask(ny, neigy[:, None].astype(_F32), sigma)
            return ("sum_separable", [(ax, ay)])
        if name not in ("gaussian", "mexican_hat"):
            raise ValueError(
                f"{name!r} neighborhood not available for hexagonal topology"
            )
        # Per-parity-class separable form. The hex offset (reference
        # xpysom.py:205-206, grid_coordinates) only shifts the x-coordinate
        # of alternate rows by 0.5, so for center (a, b) and node (i, j):
        #   Δx = (i − a) − 0.5·(off(j) − off(b)),   Δy = j − b,
        # where off(r) ∈ {0, 1} marks the shifted rows. δ = off(j) − off(b)
        # takes only three values, each a function of the two rows' parity
        # CLASSES — so the generic kernels (products/sums of f(Δx²), g(Δy²))
        # factor exactly into Σ_δ AXδ ⊗ (Ay ⊙ Mδ): three class-masked
        # separable terms for gaussian, nine for mexican hat. The update
        # drops from O(XY²·D) (pairwise H tiles) to the rect-grade
        # O(XY·(X+Y)·D) GEMMs — hex trains at rectangular speed.
        d = 2.0 * std_coeff**2 * sigma**2
        # off[r] = 1 where xx[::-2] shifted row r: rows counted from the
        # END, i.e. (Y−1−r) even. Static → numpy constants.
        off = ((Y - 1 - np.arange(Y)) % 2 == 0).astype(np.float32)
        m_same = off[:, None] * off[None, :] + (1.0 - off[:, None]) * (
            1.0 - off[None, :]
        )
        m_p = (1.0 - off[:, None]) * off[None, :]  # center class 0 → node 1
        m_m = off[:, None] * (1.0 - off[None, :])  # center class 1 → node 0
        masks = (jnp.asarray(m_same), jnp.asarray(m_p), jnp.asarray(m_m))

        ii = neigx[None, :].astype(_F32)  # node x-index i
        aa = neigx[:, None].astype(_F32)  # center x-index a
        jj = neigy[None, :].astype(_F32)  # node y-index j
        bb = neigy[:, None].astype(_F32)  # center y-index b
        dxs = (ii - aa, ii - aa - 0.5, ii - aa + 0.5)  # δ ∈ {0, +1, −1}
        dy = jj - bb

        def box(dv):
            return ((dv > -sigma) & (dv < sigma)).astype(_F32)

        if name == "gaussian":
            # ax·ay with per-axis compact masks (gaussian_generic :110-128)
            ay = jnp.exp(-jnp.square(dy) / d)
            if compact_support:
                ay = ay * box(dy)
            terms = []
            for dx, mask in zip(dxs, masks):
                ax = jnp.exp(-jnp.square(dx) / d)
                if compact_support:
                    ax = ax * box(dx)
                terms.append((ax, ay * mask))
            return ("sum_separable", terms)

        # mexican hat: p̃ = px̃ + pỹ (axis-masked like the generic form),
        # H = e^{−p̃/d}(1 − 2p̃/d) = Ex⊗Ey − (Ex·u)⊗Ey − Ex⊗(Ey·v) per class
        py = jnp.square(dy)
        if compact_support:
            py = py * box(dy)
        ey = jnp.exp(-py / d)
        v = 2.0 / d * py
        terms = []
        for dx, mask in zip(dxs, masks):
            px = jnp.square(dx)
            if compact_support:
                px = px * box(dx)
            ex = jnp.exp(-px / d)
            u = 2.0 / d * px
            terms.extend(
                [
                    (ex, ey * mask),
                    (-ex * u, ey * mask),
                    (ex, -(ey * v) * mask),
                ]
            )
        return ("sum_separable", terms)

    raise ValueError(f"unknown topology {topology!r}")


def apply_operator(op, s_flat, cnt):
    """Apply a neighborhood operator to per-BMU sufficient statistics.

    ``s_flat``: (XY, D) summed samples per BMU; ``cnt``: (XY,) counts.
    Returns ``(num_flat, den_flat)`` with shapes (XY, D) and (XY,):
    ``num[j] = Σ_b H[b, j] S[b]`` and ``den[j] = Σ_b H[b, j] cnt[b]``.
    """
    kind, payload = op
    xy, d_dim = s_flat.shape
    if kind != "sum_separable":
        # neighborhood_operator only ever returns 'sum_separable' (every
        # supported kernel factors; a dense-H 'full' branch that lived
        # here was dead code — removed, round-5 review)
        raise ValueError(f"unknown operator kind {kind!r}")
    # sum of separable terms: S viewed as (X, Y, D), cnt as (X, Y)
    x_dim = payload[0][0].shape[0]
    y_dim = payload[0][1].shape[0]
    s3 = s_flat.reshape(x_dim, y_dim, d_dim)
    c2 = cnt.reshape(x_dim, y_dim)
    num = jnp.zeros_like(s3)
    den = jnp.zeros_like(c2)
    for ax, ay in payload:
        # num[i,j,d] += Σ_{a,b} Ax[a,i]·Ay[b,j]·S[a,b,d]
        t = jnp.einsum("ai,abd->ibd", ax, s3, preferred_element_type=_F32, precision=_PRECISION)
        num = num + jnp.einsum("bj,ibd->ijd", ay, t, preferred_element_type=_F32, precision=_PRECISION)
        tc = jnp.einsum("ai,ab->ib", ax, c2, preferred_element_type=_F32, precision=_PRECISION)
        den = den + jnp.einsum("bj,ib->ij", ay, tc, preferred_element_type=_F32, precision=_PRECISION)
    return num.reshape(xy, d_dim), den.reshape(xy)
