"""Functional training/inference core of the batch SOM.

This module replaces the imperative training loop of the reference
(``xpysom_dask/xpysom.py:458-594``) with pure, jit-compiled functions over
static-shaped, pre-chunked data. Key redesigns versus the reference:

- **BMU search** is the dominant FLOPs cost: a GEMM
  (``-2 x@Wᵀ + ‖w‖²``) plus argmin (reference distances.py:11-23,
  xpysom.py:410-417). On the GPU a fused Pallas kernel does both without
  writing the distance matrix (``ops.pallas.bmu``); the XLA formulation
  here is the portable reference path.

- **The codebook update is reformulated around per-BMU sufficient
  statistics.** The reference materializes the neighborhood tensor
  ``g (N, X, Y)`` and computes ``num = g_flatᵀ @ X`` — an
  ``(XY, N) @ (N, D)`` GEMM (xpysom.py:434-440) costing ``N·XY·D`` FLOPs.
  But ``g`` depends on samples only through their BMU, so
  ``num[j] = Σ_b H[b, j] · S[b]`` with ``S[b] = Σ_{n: bmu=b} x_n`` and
  ``cnt[b] = |{n: bmu=b}|``. Accumulating ``(S, cnt)`` is an O(N·D)
  scatter-add and applying the neighborhood operator ``H`` is O(XY²·D) —
  with separable factorization O((X+Y)·XY·D) — instead of O(N·XY·D).
  The result is bit-identical math up to fp reassociation.

- **Dask data-parallelism → ``shard_map`` + ``psum``.** The reference ships
  the codebook to every Dask task and reduces partial accumulators on the
  driver once per epoch (xpysom.py:545-558). Here each device accumulates
  ``(S, cnt)`` over its data shard and a single ``psum`` over the ``data``
  mesh axis reduces them on the device interconnect; the (tiny) codebook
  update then runs
  replicated. No host round-trip inside an epoch.

- In-place accumulators become ``lax.scan`` carries; ragged final chunks
  (reference xpysom.py:563-564) become pad + mask so all shapes are static
  under jit.

- Learning-rate/σ decays are computed *inside* jit from a traced iteration
  index, so one compiled step serves every epoch (the reference recomputes
  them on host per epoch, xpysom.py:541-543).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .ops.decays import DECAY_REGISTRY
from .ops.distances import DistanceFunction
from .ops.neighborhoods import apply_operator, neighborhood_operator
from .utils.envflags import env_flag

_F32 = jnp.float32

__all__ = [
    "SomSpec",
    "grid_coordinates",
    "chunk_data",
    "make_epoch_fn",
    "make_bmu_fn",
    "make_quantization_stats_fn",
    "make_topographic_stats_fn",
]


class _FromEnv:
    """Sentinel default for ``SomSpec``'s kernel-config fields: "resolve
    from the XPYSOM_* env switches at construction" (the one documented
    env boundary). Never survives ``__post_init__`` — constructed specs
    always hold concrete values, so pickles/hashes never see it."""

    __slots__ = ()

    def __repr__(self):  # pragma: no cover - debugging aid
        return "FROM_ENV"


FROM_ENV = _FromEnv()


# BMU precision modes: the kernel's operand layouts (ops.pallas.bmu.MODES)
# plus 'highest', the f32 XLA reference.
PRECISIONS = ("packed", "bf16", "split2", "highest")


def _env_mode(default="packed") -> str:
    """``XPYSOM_BMU_PRECISION``, read at spec construction. An
    unrecognized value warns and falls back to ``default`` (a stale env
    var must not break every constructor in the process; explicit kwargs
    raise instead)."""
    m = os.environ.get("XPYSOM_BMU_PRECISION", "").lower()
    if m in PRECISIONS:
        return m
    if m:
        import warnings

        warnings.warn(
            f"XPYSOM_BMU_PRECISION={m!r} not recognized "
            f"(expected {'|'.join(PRECISIONS)}); using {default!r}"
        )
    return default


def _env_tiles():
    """``XPYSOM_BMU_TILES=BNxBJ[xWARPSxSTAGES]``, read at spec
    construction; None (unset or invalid, with a warning) means the
    kernel's per-width block table."""
    s = os.environ.get("XPYSOM_BMU_TILES", "")
    if not s:
        return None
    from .ops.pallas.bmu import validate_blocks

    try:
        return validate_blocks(s.lower().split("x"))
    except ValueError as e:
        import warnings

        warnings.warn(f"XPYSOM_BMU_TILES={s!r} ignored: {e}")
        return None


@dataclass(frozen=True)
class SomSpec:
    """Static (hashable) SOM configuration — everything that shapes the
    compiled computation. Mirrors the reference constructor surface
    (xpysom.py:73-82); array state (the codebook) lives outside."""

    x: int
    y: int
    input_len: int
    sigma: float
    sigmaN: float
    learning_rate: float
    learning_rateN: float
    decay: str = "exponential"
    neighborhood: str = "gaussian"
    std_coeff: float = 0.5
    topology: str = "rectangular"
    distance: str = "euclidean"
    distance_kwargs: Tuple[Tuple[str, object], ...] = ()

    compact_support: bool = False

    # Fused-BMU-kernel configuration (first-class config surface, matching
    # the reference's constructor-kwargs-only config bar — SURVEY §5,
    # reference xpysom.py:73-161). These are PART OF the hashable spec, so
    # every jit cache keys on them: switching modes in one process simply
    # compiles a second executable. OMITTED fields (the ``FROM_ENV``
    # sentinel default) are resolved from the XPYSOM_* env switches in
    # ``__post_init__`` — ONCE, when the spec is constructed; no traced
    # code reads os.environ. A CONCRETE value — including ``None``, which
    # means the defaults ('packed' / the per-width block table / kernel
    # on) — is env-blind: ``XPySom`` stores its resolved values, so an
    # already-constructed model never picks up a later env change.
    bmu_precision: object = FROM_ENV  # one of PRECISIONS
    bmu_tiles: object = FROM_ENV  # (BN, BJ[, warps, stages]); None = table
    use_pallas: object = FROM_ENV  # False = plain-XLA BMU formulation

    def __post_init__(self):
        # Concrete field values win over env; the resolved values take
        # part in the spec's hash/eq, so every jit and lru cache keys on
        # them.
        if self.use_pallas is FROM_ENV:
            object.__setattr__(
                self, "use_pallas", not env_flag("XPYSOM_NO_PALLAS")
            )
        elif self.use_pallas is not None:
            object.__setattr__(self, "use_pallas", bool(self.use_pallas))
        if self.bmu_precision is FROM_ENV:
            object.__setattr__(self, "bmu_precision", _env_mode())
        elif self.bmu_precision is not None:
            # validated HERE, at the config boundary, not at first trace
            mode = str(self.bmu_precision).lower()
            if mode not in PRECISIONS:
                raise ValueError(
                    f"bmu_precision={self.bmu_precision!r} not recognized "
                    f"({'|'.join(PRECISIONS)})"
                )
            object.__setattr__(self, "bmu_precision", mode)
        if self.bmu_tiles is FROM_ENV:
            object.__setattr__(self, "bmu_tiles", _env_tiles())
        elif self.bmu_tiles is not None:
            from .ops.pallas.bmu import validate_blocks

            # a tuple, never a list: the spec must stay hashable
            object.__setattr__(
                self, "bmu_tiles", validate_blocks(self.bmu_tiles)
            )

    @property
    def xy(self) -> int:
        return self.x * self.y

    def distance_fn(self) -> DistanceFunction:
        return DistanceFunction(self.distance, dict(self.distance_kwargs))


def grid_coordinates(x: int, y: int, topology: str):
    """Euclidean grid coordinate meshes ``(xx, yy)`` of shape ``(y, x)``
    ('xy' meshgrid indexing), with the hexagonal row offset
    ``xx[::-2] -= 0.5`` applied exactly as the reference does
    (xpysom.py:201-206): every other row *counted from the end* is shifted
    left half a cell."""
    xx, yy = np.meshgrid(np.arange(x), np.arange(y))
    xx = xx.astype(np.float64)
    yy = yy.astype(np.float64)
    if topology == "hexagonal":
        xx[::-2] -= 0.5
    return xx, yy


def chunk_data(
    data: np.ndarray, chunk: int, multiple_of: int = 1, min_chunks: int = 1
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad + reshape ``(N, D)`` data into static-shaped ``(C, chunk, D)``
    chunks and a ``(C, chunk)`` float32 validity mask. ``C`` is rounded up
    to a multiple of ``multiple_of`` (the number of data shards) so the
    leading axis shards evenly; ``min_chunks`` floors it (fully-masked
    padding chunks — used by the inference shape-bucketing so the chunk
    COUNT, which is part of the compiled shape, lands on a small ladder)."""
    n, d = data.shape
    c = max(min_chunks, -(-n // chunk))
    c = -(-c // multiple_of) * multiple_of
    total = c * chunk
    padded = np.zeros((total, d), dtype=np.float32)
    padded[:n] = data
    mask = np.zeros((total,), dtype=np.float32)
    mask[:n] = 1.0
    return (
        padded.reshape(c, chunk, d),
        mask.reshape(c, chunk),
        n,
    )


def _neighborhood_op(spec: SomSpec, sigma):
    neigx = jnp.arange(spec.x, dtype=_F32)
    neigy = jnp.arange(spec.y, dtype=_F32)
    xx, yy = grid_coordinates(spec.x, spec.y, spec.topology)
    return neighborhood_operator(
        spec.neighborhood,
        spec.topology,
        neigx,
        neigy,
        jnp.asarray(xx, _F32),
        jnp.asarray(yy, _F32),
        spec.std_coeff,
        spec.compact_support,
        sigma,
    )


def _pallas_bmu_kind(
    dist: DistanceFunction, d_dim: int, use_pallas=None, mode=None
):
    """Which fused BMU kernel serves this search: 'euclidean' / 'cosine'
    (the Hopper kernel, ``ops.pallas.bmu``; cosine rides it through the
    normalised codebook) or None (the XLA reference: distance matrix +
    argmin, ``ops.distances``).

    The kernel runs on the ``gpu`` backend only; every other activation,
    ``bmu_precision='highest'``, features wider than the kernel's
    ``MAX_D`` and ``use_pallas=False`` (the reference's ``_no_opt``
    pattern, tests.py:24-31) take the XLA path. Runs at trace time and
    reads no env: the ``XPYSOM_NO_PALLAS`` switch is resolved into
    ``use_pallas`` at spec construction."""
    from .ops.pallas.bmu import MAX_D

    if use_pallas is False or mode == "highest":
        return None
    if jax.default_backend() != "gpu":
        return None
    if dist.name in ("euclidean", "cosine") and d_dim <= MAX_D:
        return dist.name
    return None


def _bmu_config(spec: Optional["SomSpec"]):
    """(use_pallas, mode, tiles) for the kernel dispatch. A spec carries
    them as hashable fields so every jit cache keys on them; a ``None``
    spec (direct core users) means the defaults (kernel on where it
    exists, 'packed', the per-width block table)."""
    if spec is None:
        return None, None, None
    return spec.use_pallas, spec.bmu_precision, spec.bmu_tiles


def codebook_center(w_flat):
    """Per-feature midrange ``(min + max) / 2`` of the codebook: the
    kernel's translation center. Min and max reduce exactly in any order,
    so a codebook sharded over devices gets the same center to the last
    bit (a mean would not), and sharded searches match unsharded ones."""
    return 0.5 * (jnp.min(w_flat, axis=0) + jnp.max(w_flat, axis=0))


def bmu_searcher(
    dist: DistanceFunction, w_flat, w_sq=None, spec=None, *, top2=False,
    center=None,
):
    """Build ``search(x) -> (idx, val)`` — or ``(idx, val, idx2, val2)``
    with ``top2`` — for one codebook (reference xpysom.py:410-417,
    731-734). First-index tie-breaking matches NumPy/CuPy argmin; top-2
    follows a stable argsort.

    Build it OUTSIDE a scan over chunks: the kernel's codebook operands
    (bf16 splits, padding) are then prepared once per codebook.

    ``spec`` supplies the kernel config (``use_pallas`` /
    ``bmu_precision`` / ``bmu_tiles``); ``dist`` is separate because
    QE/TE search by euclidean distance whatever the activation
    (reference xpysom.py:632-645) while honouring the SOM's config. The
    euclidean kernel is centred by ``center`` (default:
    ``codebook_center``) — translation-invariant for the argmin, it
    shrinks the bf16-split error for data away from the origin; its
    values shift by a per-sample constant."""
    use_pallas, mode, tiles = _bmu_config(spec)
    kind = _pallas_bmu_kind(dist, w_flat.shape[-1], use_pallas, mode)
    if kind is not None:
        from .ops.pallas import bmu as kernel

        kw = dict(mode=mode or "packed", top2=top2, blocks=tiles)
        if kind == "cosine":
            return kernel.cosine_searcher(w_flat, **kw)
        if center is None:
            center = codebook_center(w_flat)
        return kernel.searcher(w_flat, center=center, **kw)

    def search(x):
        d = dist.flat(x, w_flat, w_sq)
        if top2:
            neg, idx = jax.lax.top_k(-d, 2)  # stable: lower index first
            idx = idx.astype(jnp.int32)
            return idx[:, 0], -neg[:, 0], idx[:, 1], -neg[:, 1]
        return jnp.argmin(d, axis=1).astype(jnp.int32), jnp.min(d, axis=1)

    return search


def _bmu_chunk(dist: DistanceFunction, x, w_flat, w_sq, spec=None):
    """Flat BMU indices for one chunk (one-shot ``bmu_searcher``)."""
    return bmu_searcher(dist, w_flat, w_sq, spec)(x)[0]


def _use_split_scatter(d_dim: int) -> bool:
    """Scatter ``S`` and ``cnt`` separately instead of as one augmented
    ``[x | 1]`` row? Auto-on when ``d_dim`` is a multiple of 128, where
    the +1 column would start a new 128-wide layout tile. The rule comes
    from a layout that pads rows to 128 lanes; it is not measured on the
    GPU yet (ROADMAP). ``XPYSOM_SPLIT_SCATTER`` forces either way: unset/empty =
    this rule; otherwise the truthiness grammar of every XPYSOM_* switch.

    EAGER resolver: called from factory bodies when the executable is
    built, never under trace."""
    from .utils.envflags import env_tristate

    forced = env_tristate("XPYSOM_SPLIT_SCATTER")
    if forced is not None:
        return forced
    return d_dim >= 128 and d_dim % 128 == 0


def scatter_sum(idx, rows, n_out: int):
    """``zeros((n_out, C)).at[idx].add(rows)`` for ``rows (N, C)`` float32,
    with a result that does not depend on the order of the additions.

    The GPU's scatter-add sums rows that share an index in whatever order
    its atomics land, so an f32 total changes in the last bits from run to
    run, and on a trained codebook a near-tied winner then flips and the
    runs part. Here each column is scaled by a power of two to its
    maximum over the chunk and cut into two fixed-point int32 limbs of
    ``L = 30 − ⌈log₂ N⌉`` bits; integer sums are exact in any order, and
    each total becomes f32 once. ``2L`` bits relative to the column's
    largest row (32 at 16384 rows) is finer than the f32 rounding of a
    sequential sum. A column with a non-finite row gives NaN."""
    n, c = rows.shape
    lbits = 30 - max(n - 1, 1).bit_length()  # N · 2^L ≤ 2^30 per limb sum
    step = float(2**lbits)
    peak = jnp.max(jnp.abs(rows), axis=0)
    _, e = jnp.frexp(peak)  # |rows| < 2^e column by column
    y = jnp.ldexp(rows, lbits - e)  # exact: a power-of-two scaling
    hi = jnp.floor(y)
    lo = jnp.round((y - hi) * step)  # y - hi is exact, in [0, 1)
    limbs = jnp.concatenate([hi, lo], axis=1).astype(jnp.int32)
    acc = jnp.zeros((n_out, 2 * c), jnp.int32).at[idx].add(limbs)
    out = acc[:, :c].astype(_F32) + acc[:, c:].astype(_F32) * (1.0 / step)
    out = jnp.ldexp(out, e - lbits)
    return jnp.where(jnp.isfinite(peak), out, jnp.nan)


def _accumulate_stats(
    dist: DistanceFunction,
    w_flat,
    w_sq,
    data,
    mask,
    xy,
    spec=None,
    *,
    split_scatter=None,
    init=None,
):
    """Scan chunks, scatter-accumulating per-BMU sufficient statistics
    ``S[b] = Σ x_n`` and ``cnt[b] = Σ 1`` (masked rows contribute zero;
    ``scatter_sum`` makes each chunk's sums independent of the device's
    addition order, so a run repeats to the bit),
    starting from zeros or from ``init = (S, cnt)``: a stream continues
    the scan across superbatches, so its additions happen in the order of
    one resident scan over the same chunks.

    ``S`` and ``cnt`` ride ONE XLA scatter-add of the augmented rows
    ``[x | 1]·m``, or two separate scatters when ``split_scatter``
    (``_use_split_scatter``; factories resolve it at build time, ``None``
    resolves at call time).

    Each chunk scatters into a *fresh* per-chunk partial which is then
    added to the carry: scattering +1.0 rows directly into a large f32
    total silently drops increments once a node's count passes 2^24
    (f32 ulp = 2); chunk-sized partials keep every addend representable
    at huge-N scale (the residual is ≤1 ulp per chunk-total add)."""

    d_dim = data.shape[-1]
    if split_scatter is None:
        split_scatter = _use_split_scatter(d_dim)
    search = bmu_searcher(dist, w_flat, w_sq, spec)

    if split_scatter:

        def body(carry, xs):
            s_acc, c_acc = carry
            x, m = xs
            bmu = search(x)[0]
            xm = x * m[:, None]
            s_part = scatter_sum(bmu, xm, xy)
            c_part = jnp.zeros((xy,), dtype=_F32).at[bmu].add(m)  # exact
            return (s_acc + s_part, c_acc + c_part), None

        if init is None:
            init = (
                jnp.zeros((xy, d_dim), dtype=_F32),
                jnp.zeros((xy,), dtype=_F32),
            )
        (s, cnt), _ = jax.lax.scan(body, tuple(init), (data, mask))
        return s, cnt

    def body(carry, xs):
        x, m = xs
        bmu = search(x)[0]
        aug = (
            jnp.concatenate([x, jnp.ones((x.shape[0], 1), _F32)], axis=1)
            * m[:, None]
        )
        part = scatter_sum(bmu, aug, xy)
        return carry + part, None

    if init is None:
        init = jnp.zeros((xy, d_dim + 1), dtype=_F32)
    else:
        init = jnp.concatenate([init[0], init[1][:, None]], axis=1)
    acc, _ = jax.lax.scan(body, init, (data, mask))
    return acc[:, :d_dim], acc[:, d_dim]


def _update_from_stats(spec: SomSpec, w_flat, s, cnt, eta, sigma):
    """Neighborhood-smoothed codebook update from global sufficient
    statistics: ``W' = where(den ≠ 0, num / den, W)``
    (reference xpysom.py:446-455,577). ``eta`` scales both num and den —
    kept for exact semantic fidelity to the reference's merge rule."""
    op = _neighborhood_op(spec, sigma)
    num, den = apply_operator(op, s, cnt)
    num = num * eta
    den = den * eta
    den = den[:, None]
    return jnp.where(den != 0, num / den, w_flat)


def _decays(spec: SomSpec, t, num_epochs: int):
    decay = DECAY_REGISTRY[spec.decay]
    eta = decay(spec.learning_rate, spec.learning_rateN, t, num_epochs)
    sig = decay(spec.sigma, spec.sigmaN, t, num_epochs)
    return eta, sig


def make_epoch_step(spec: SomSpec, num_epochs: int, psum_axis: Optional[str] = None):
    """Build the *pure* (un-jitted) epoch step
    ``step(w, data, mask, t) -> w'``. When ``psum_axis`` is given the
    per-shard sufficient statistics are ``psum``-reduced over that mesh
    axis (for use under ``shard_map``)."""
    dist = spec.distance_fn()
    xy = spec.xy
    # the scatter-formulation env hook resolves HERE, at build time — the
    # traced step closes over a boolean, never reads env
    split = _use_split_scatter(spec.input_len)

    def step(w, data, mask, t):
        w_flat = w.reshape(xy, spec.input_len)
        w_sq = (
            jnp.sum(jnp.square(w_flat), axis=1, keepdims=True)
            if dist.can_cache
            else None
        )
        eta, sig = _decays(spec, t, num_epochs)
        s, cnt = _accumulate_stats(
            dist, w_flat, w_sq, data, mask, xy, spec, split_scatter=split
        )
        if psum_axis is not None:
            s = jax.lax.psum(s, psum_axis)
            cnt = jax.lax.psum(cnt, psum_axis)
        new_flat = _update_from_stats(spec, w_flat, s, cnt, eta, sig)
        return new_flat.reshape(w.shape)

    return step


@lru_cache(maxsize=64)
def make_stats_fn(spec: SomSpec, mesh: Optional[Mesh] = None):
    """Compile the accumulate-only half of an epoch:
    ``stats(w, data, mask) -> (S, cnt)`` per-BMU sufficient statistics.
    Used by the streaming pipeline to fold superbatches of an epoch that
    does not fit on device (see ``parallel.pipeline``); with a mesh the
    shard partials are psum-reduced so the result is replicated. Without
    one, ``stats(w, data, mask, init)`` continues from the statistics
    ``init`` of the superbatches before (``_accumulate_stats``)."""
    dist = spec.distance_fn()
    xy = spec.xy
    split = _use_split_scatter(spec.input_len)

    def run(w, data, mask, init=None):
        w_flat = w.reshape(xy, spec.input_len)
        w_sq = (
            jnp.sum(jnp.square(w_flat), axis=1, keepdims=True)
            if dist.can_cache
            else None
        )
        s, cnt = _accumulate_stats(
            dist, w_flat, w_sq, data, mask, xy, spec, split_scatter=split,
            init=init,
        )
        if mesh is not None:
            s = jax.lax.psum(s, "data")
            cnt = jax.lax.psum(cnt, "data")
        return s, cnt

    if mesh is None:
        return jax.jit(run)
    sharded = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(P(), P("data"), P("data")),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


@lru_cache(maxsize=64)
def make_update_fn(spec: SomSpec, num_epochs: int):
    """Compile the finalize half of an epoch:
    ``update(w, S, cnt, t) -> w'`` — decays + neighborhood operator +
    ``where(den != 0, num/den, W)`` merge. Tiny (O(XY²·D) worst case);
    runs replicated."""

    def run(w, s, cnt, t):
        eta, sig = _decays(spec, t, num_epochs)
        w_flat = w.reshape(spec.xy, spec.input_len)
        new_flat = _update_from_stats(spec, w_flat, s, cnt, eta, sig)
        return new_flat.reshape(w.shape)

    return jax.jit(run, donate_argnums=(0,))


@lru_cache(maxsize=64)
def make_epoch_fn(spec: SomSpec, num_epochs: int, mesh: Optional[Mesh] = None):
    """Compile one training epoch.

    Returns ``epoch(w, data, mask, t) -> w'`` where ``w`` is the
    ``(X, Y, D)`` float32 codebook, ``data``/``mask`` are the pre-chunked
    ``(C, chunk, D)``/``(C, chunk)`` epoch inputs, and ``t`` is the (traced)
    iteration index. With a mesh, the chunk axis is sharded over the
    ``'data'`` axis and per-shard statistics are ``psum``-reduced on the
    device interconnect — the replacement for the reference's per-epoch Dask
    ``delayed(sum)`` + driver ``compute`` barrier (xpysom.py:545-558)."""
    if mesh is None:
        step = make_epoch_step(spec, num_epochs)
        return jax.jit(step, donate_argnums=(0,))
    step = make_epoch_step(spec, num_epochs, psum_axis="data")

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P("data"), P("data"), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(0,))


@lru_cache(maxsize=64)
def make_train_fn(spec: SomSpec, num_epochs: int, mesh: Optional[Mesh] = None):
    """Compile a whole training run:
    ``train(w, data, mask, iter_beg, iter_end) -> w'`` — a
    ``lax.while_loop`` over epochs *inside one executable*, so a full
    multi-epoch run is a single dispatch with zero host round-trips
    (the reference synchronizes with the driver every epoch,
    xpysom.py:515-577; here the decay schedule is computed on-device from
    the loop counter). ``iter_beg/iter_end`` are traced, preserving the
    segmented-training API."""
    psum_axis = "data" if mesh is not None else None
    step = make_epoch_step(spec, num_epochs, psum_axis=psum_axis)

    def run(w, data, mask, iter_beg, iter_end):
        def body(t, w):
            return step(w, data, mask, t)

        return jax.lax.fori_loop(iter_beg, iter_end, body, w)

    if mesh is None:
        return jax.jit(run, donate_argnums=(0,))
    sharded = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(P(), P("data"), P("data"), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(0,))


@lru_cache(maxsize=64)
def make_bmu_fn(spec: SomSpec, mesh: Optional[Mesh] = None):
    """Compile BMU (winner) search over pre-chunked data:
    ``bmu(w, data) -> (C, chunk) int32`` flat grid indices."""
    dist = spec.distance_fn()
    xy = spec.xy

    def run(w, data):
        w_flat = w.reshape(xy, spec.input_len)
        w_sq = (
            jnp.sum(jnp.square(w_flat), axis=1, keepdims=True)
            if dist.can_cache
            else None
        )

        search = bmu_searcher(dist, w_flat, w_sq, spec)

        def body(_, x):
            return None, search(x)[0]

        _, bmu = jax.lax.scan(body, None, data)
        return bmu

    if mesh is None:
        return jax.jit(run)

    sharded = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(P(), P("data")),
        out_specs=P("data"),
        check_vma=False,
    )
    return jax.jit(sharded)


@lru_cache(maxsize=64)
def make_quantization_stats_fn(spec: SomSpec, mesh: Optional[Mesh] = None):
    """Compile quantization-error statistics:
    ``qstats(w, data, mask) -> (Σ‖x - W[bmu]‖, Σ mask)``.

    Matches the reference's definition: BMU by *euclidean* distance
    regardless of the activation distance (xpysom.py:632-645,673-707), then
    the mean L2 norm of the residuals."""
    xy = spec.xy
    eucl = DistanceFunction("euclidean")

    def run(w, data, mask):
        w_flat = w.reshape(xy, spec.input_len)
        w_sq = jnp.sum(jnp.square(w_flat), axis=1, keepdims=True)
        search = bmu_searcher(eucl, w_flat, w_sq, spec)

        def body(carry, xs):
            tot, n = carry
            x, m = xs
            bmu = search(x)[0]
            err = jnp.linalg.norm(x - w_flat[bmu], axis=1)
            return (tot + jnp.sum(err * m), n + jnp.sum(m)), None

        (tot, n), _ = jax.lax.scan(body, (jnp.float32(0), jnp.float32(0)), (data, mask))
        return tot, n

    if mesh is None:
        return jax.jit(run)

    def run_psum(w, data, mask):
        tot, n = run(w, data, mask)
        return jax.lax.psum(tot, "data"), jax.lax.psum(n, "data")

    sharded = jax.shard_map(
        run_psum,
        mesh=mesh,
        in_specs=(P(), P("data"), P("data")),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def te_spec(spec: "SomSpec") -> "SomSpec":
    """The spec TE's top-2 search runs with: exact by contract like
    training's, so 'split2' maps to 'packed'; 'bf16' stays opt-in and
    'highest' stays on the XLA reference. One source of truth for the
    single-device and 2-D grid-mesh TE paths."""
    import dataclasses

    mode = spec.bmu_precision
    if mode not in ("bf16", "highest"):
        mode = "packed"
    return dataclasses.replace(spec, bmu_precision=mode)


def te_uses_fused(spec: "SomSpec") -> bool:
    """Whether ``topographic_error``'s top-2 search runs the fused kernel
    instead of materialising the (chunk, XY) distance matrix for
    ``lax.top_k``. Callers use this to size chunks: the fused path never
    materialises the matrix, so it takes training-sized chunks instead of
    the ``_matrix_chunk`` budget."""
    te = te_spec(spec)
    return (
        _pallas_bmu_kind(
            DistanceFunction("euclidean"), spec.input_len, te.use_pallas,
            te.bmu_precision,
        )
        == "euclidean"
    )


@lru_cache(maxsize=64)
def make_topographic_stats_fn(spec: SomSpec, mesh: Optional[Mesh] = None):
    """Compile topographic-error statistics:
    ``tstats(w, data, mask) -> (Σ errors, Σ mask)``.

    Top-2 BMUs by euclidean distance (reference xpysom.py:731-734), then
    rect adjacency ``|Δx| ≤ 1 ∧ |Δy| ≤ 1`` (xpysom.py:736-740) or hex
    euclidean-offset distance > 1.5 (xpysom.py:741-746). The hex branch
    indexes the ``(y, x)``-shaped coordinate mesh with ``[bx, by]`` exactly
    as the reference does — self-consistent for the square maps it targets."""
    xy = spec.xy
    if spec.topology == "hexagonal" and spec.x != spec.y:
        # The hex branch replicates the reference's indexing of the
        # (y, x)-shaped coordinate mesh with [bx, by] (xpysom.py:742-743),
        # which is only self-consistent for square maps; the reference
        # raises IndexError on non-square input, XLA would silently clamp.
        raise ValueError(
            "topographic_error on hexagonal topology requires a square map "
            f"(got {spec.x}x{spec.y}); the reference's coordinate indexing "
            "(xpysom.py:742-743) is undefined for non-square hex maps"
        )
    xx_np, yy_np = grid_coordinates(spec.x, spec.y, spec.topology)
    xx = jnp.asarray(xx_np, _F32)
    yy = jnp.asarray(yy_np, _F32)

    te = te_spec(spec)
    eucl = DistanceFunction("euclidean")

    def run(w, data, mask):
        w_flat = w.reshape(xy, spec.input_len)
        w_sq = jnp.sum(jnp.square(w_flat), axis=1, keepdims=True)
        search = bmu_searcher(eucl, w_flat, w_sq, te, top2=True)

        def body(carry, xs):
            errs, n = carry
            x, m = xs
            i1, _, i2, _ = search(x)
            b1x, b1y = i1 // spec.y, i1 % spec.y
            b2x, b2y = i2 // spec.y, i2 % spec.y
            if spec.topology == "rectangular":
                bad = (jnp.abs(b1x - b2x) > 1) | (jnp.abs(b1y - b2y) > 1)
            else:
                dx = xx[b1x, b1y] - xx[b2x, b2y]
                dy = yy[b1x, b1y] - yy[b2x, b2y]
                bad = jnp.sqrt(dx * dx + dy * dy) > 1.5
            return (errs + jnp.sum(bad.astype(_F32) * m), n + jnp.sum(m)), None

        (errs, n), _ = jax.lax.scan(
            body, (jnp.float32(0), jnp.float32(0)), (data, mask)
        )
        return errs, n

    if mesh is None:
        return jax.jit(run)

    def run_psum(w, data, mask):
        errs, n = run(w, data, mask)
        return jax.lax.psum(errs, "data"), jax.lax.psum(n, "data")

    sharded = jax.shard_map(
        run_psum,
        mesh=mesh,
        in_specs=(P(), P("data"), P("data")),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def clear_program_caches() -> None:
    """Drop every ``lru_cache``d program factory across the package.

    The scatter env hook (``XPYSOM_SPLIT_SCATTER``) resolves EAGERLY at
    factory-build time — compiled programs close over a boolean and never
    read env — so flipping it after a program is cached has no effect on
    equal ``(spec, num_epochs, mesh)`` keys. A/B tests that toggle it
    must call this between arms, or they compare a cached program against
    itself."""
    import sys as _sys

    mods = [_sys.modules[__name__]]
    for name in (
        "xpysom_dask_tpu.models.population",
        "xpysom_dask_tpu.parallel.grid_sharded",
    ):
        if name in _sys.modules:
            mods.append(_sys.modules[name])
        else:  # import so a pre-warm clear covers them too
            __import__(name)
            mods.append(_sys.modules[name])
    for mod in mods:
        for obj in vars(mod).values():
            if callable(obj) and hasattr(obj, "cache_clear"):
                obj.cache_clear()
