"""Fused BMU search for NVIDIA Hopper: one Pallas kernel on the Triton route.

For each sample the kernel returns the argmin over codebook nodes of the
partial squared euclidean distance ``-2 x·w + ‖w‖²`` (the reference's
'euclidean' activation, distances.py:11-23, with the argmin of
xpysom.py:416) without writing the ``(N, XY)`` distance matrix to device
memory. The reference computed the same thing as a cuBLAS GEMM followed
by ``argmin`` over the materialised matrix; here the GEMM and the argmin
are one kernel:

- each program owns a block of ``BN`` samples and walks the codebook in
  ``BJ``-node tiles with an in-kernel loop;
- each tile is one or more ``pl.dot`` products of bf16 operands with f32
  accumulation on the tensor cores, plus the f32 ``‖w‖²`` row;
- a running (min, first-index argmin) — and the runner-up for
  ``top2=True`` — lives in registers, and only ``(N,)`` indices and
  values are written.

Precision modes are operand layouts prepared at the call site, so they
all ride the same kernel:

- ``packed`` (default): ``x·w ≈ xh·wh + xl·wh + xh·wl`` from bf16 splits
  of both operands (the dropped ``xl·wl`` is O(2⁻¹⁶) relative), three
  products with K=D. Exact argmin against float64 outside near-ties.
- ``split2``: ``(xh + xl)·wh`` — the 16-bit-truncated sample against the
  bf16-rounded codebook, with ``‖w_h‖²`` of the ROUNDED codebook so the
  distance is self-consistent; two products with K=D.
- ``bf16``: a single bf16 product (the throughput mode; flips winners
  whose float64 margin is below ~2⁻⁸ of the operand scale).

The splits use ``jax.lax.reduce_precision``: the naive
``bf16(x - f32(bf16(x)))`` is elided to zero under XLA's
``--xla_allow_excess_precision``.

Tie-breaking matches ``jnp.argmin`` (first index): within a tile the
reduction keeps the lowest lane, across tiles a strict ``<`` keeps the
earlier tile's winner.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = [
    "searcher",
    "cosine_searcher",
    "bmu_euclidean",
    "bmu_cosine",
    "MODES",
    "MAX_D",
    "blocks_for",
]

# Precision modes the kernel implements ('highest' is the XLA reference).
MODES = ("packed", "bf16", "split2")

# Widest feature dimension the kernel takes: the widest at which it was
# timed faster than the XLA reference on an H100 (PERF.md). Wider
# features take the XLA path.
MAX_D = 512

_BIG_I32 = np.int32(2**31 - 1)

# (BN, BJ, num_warps, num_stages) by padded feature width, each the
# fastest candidate timed on an H100 at 16384 samples × 16384 nodes
# (benchmarks/bmu_blocks.py, PERF.md); D=32 shares the D=16/64 row, which
# won at both. Every row fits the shared-memory budget in every mode.
_BLOCKS = {
    16: (64, 128, 4, 3),
    32: (64, 128, 4, 3),
    64: (64, 128, 4, 3),
    128: (128, 128, 8, 2),
    256: (128, 64, 8, 1),
    512: (64, 32, 4, 1),
}


def _pow2_at_least(n: int, floor: int = 16) -> int:
    return max(floor, 1 << max(int(n) - 1, 0).bit_length())


def blocks_for(d_dim: int):
    """Default ``(BN, BJ, num_warps, num_stages)`` for feature width D."""
    return _BLOCKS[_pow2_at_least(d_dim)]


def validate_blocks(blocks):
    """Normalise a block override: ``(BN, BJ)`` or ``(BN, BJ, num_warps,
    num_stages)``; BN and BJ powers of two ≥ 16 (Triton tiles are powers
    of two and ``pl.dot`` needs every dimension ≥ 16). Returns a tuple or
    raises ValueError."""
    try:
        vals = tuple(int(v) for v in blocks)
    except (TypeError, ValueError):
        vals = ()
    if len(vals) not in (2, 4):
        raise ValueError(
            f"bmu_tiles={blocks!r} invalid: expected (BN, BJ) or "
            "(BN, BJ, num_warps, num_stages)"
        )
    bn, bj = vals[:2]
    for v in (bn, bj):
        if v < 16 or v & (v - 1):
            raise ValueError(
                f"bmu_tiles={blocks!r} invalid: BN and BJ must be powers "
                "of two >= 16"
            )
    if len(vals) == 4:
        warps, stages = vals[2:]
        if warps not in (1, 2, 4, 8, 16) or stages < 1:
            raise ValueError(
                f"bmu_tiles={blocks!r} invalid: num_warps must be a power "
                "of two <= 16 and num_stages >= 1"
            )
    return vals


def _split_bf16(a):
    """Elision-safe Dekker-style bf16 split: ``a ≈ f32(hi) + f32(lo)``."""
    hi = jax.lax.reduce_precision(a, exponent_bits=8, mantissa_bits=7)
    return hi.astype(jnp.bfloat16), (a - hi).astype(jnp.bfloat16)


def _pad_to(a, size, axis, value=0):
    pad = size - a.shape[axis]
    if pad == 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return jnp.pad(a, widths, constant_values=value)


def _kernel(*refs, pairs, n_x, n_w, bj, nj, top2):
    """One program: BN samples against the whole codebook, BJ nodes per
    loop step. ``pairs`` lists the (sample operand, codebook operand)
    products whose sum is ``-2 x·w``; the f32 ``‖w‖²`` row is added last
    (padded nodes carry +inf there, so they never win)."""
    x_refs = refs[:n_x]
    w_refs = refs[n_x:n_x + n_w]
    wsq_ref = refs[n_x + n_w]
    out_refs = refs[n_x + n_w + 1:]
    xs = [r[...] for r in x_refs]  # (BN, Dp) bf16, on chip for the walk
    bn = xs[0].shape[0]
    inf = jnp.float32(jnp.inf)

    def pick(va, ia, vb, ib):
        # value, then lowest index: a stable argsort's order
        a_wins = (va < vb) | ((va == vb) & (ia < ib))
        return jnp.where(a_wins, va, vb), jnp.where(a_wins, ia, ib)

    def body(j, carry):
        sl = pl.ds(pl.multiple_of(j * bj, bj), bj)
        ws = [r[sl, :] for r in w_refs]  # (BJ, Dp) bf16
        acc = None
        for a, b in pairs:
            p = pl.dot(xs[a], ws[b], trans_b=True)  # f32 accumulation
            acc = p if acc is None else acc + p
        d = acc + wsq_ref[sl][None, :]
        t_min = jnp.min(d, axis=1)
        t_arg = jnp.argmin(d, axis=1).astype(jnp.int32)
        best, best_i = carry[0], carry[1]
        better = t_min < best
        new = (
            jnp.where(better, t_min, best),
            jnp.where(better, t_arg + j * bj, best_i),
        )
        if not top2:
            return new
        # runner-up: the tile's best after masking its winning LANE (an
        # equal-valued duplicate stays a candidate), and the loser of the
        # top-1 contest
        lane = jax.lax.broadcasted_iota(jnp.int32, d.shape, 1)
        masked = jnp.where(lane == t_arg[:, None], inf, d)
        t_min2 = jnp.min(masked, axis=1)
        t_arg2 = jnp.argmin(masked, axis=1).astype(jnp.int32) + j * bj
        lose_v = jnp.where(better, best, t_min)
        lose_i = jnp.where(better, best_i, t_arg + j * bj)
        v2, i2 = pick(carry[2], carry[3], t_min2, t_arg2)
        v2, i2 = pick(v2, i2, lose_v, lose_i)
        return new + (v2, i2)

    init = (jnp.full((bn,), inf), jnp.zeros((bn,), jnp.int32))
    if top2:
        init += (jnp.full((bn,), inf), jnp.full((bn,), _BIG_I32, jnp.int32))
    res = jax.lax.fori_loop(0, nj, body, init)
    # outputs: idx, val[, idx2, val2]
    for ref, k in zip(out_refs, (1, 0, 3, 2)):
        ref[...] = res[k]


def _search(xs, ws, wsq, pairs, *, top2, blocks, interpret):
    n_pad, d_pad = xs[0].shape
    xy_pad = ws[0].shape[0]
    bn, bj, warps, stages = blocks
    out_shape = [
        jax.ShapeDtypeStruct((n_pad,), jnp.int32),
        jax.ShapeDtypeStruct((n_pad,), jnp.float32),
    ] * (2 if top2 else 1)
    kernel = partial(
        _kernel, pairs=pairs, n_x=len(xs), n_w=len(ws), bj=bj,
        nj=xy_pad // bj, top2=top2,
    )
    return pl.pallas_call(
        kernel,
        grid=(n_pad // bn,),
        in_specs=[pl.BlockSpec((bn, d_pad), lambda i: (i, 0))] * len(xs)
        + [pl.BlockSpec((xy_pad, d_pad), lambda i: (0, 0))] * len(ws)
        + [pl.BlockSpec((xy_pad,), lambda i: (0,))],
        out_specs=[pl.BlockSpec((bn,), lambda i: (i,))] * len(out_shape),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=warps, num_stages=stages
        ),
        interpret=interpret,
        name="bmu_top2" if top2 else "bmu",
    )(*xs, *ws, wsq)


# Shared memory a program may use, with headroom below the H100's
# 227 KB per block for the compiler's own buffers.
_SMEM_BUDGET = 200 * 1024


def _smem_bytes(bn, bj, stages, d_pad, n_x, n_w):
    """bf16 bytes of the on-chip operands: the BN-row sample tiles, and
    ``stages`` buffers of each BJ-row codebook tile (the layout the
    compiler reported when a block did not fit)."""
    return 2 * d_pad * (bn * n_x + stages * bj * n_w)


def _fit_smem(bn, bj, stages, d_pad, n_x, n_w):
    """Shrink (stages, then BJ, then BN) until the operands fit."""
    while _smem_bytes(bn, bj, stages, d_pad, n_x, n_w) > _SMEM_BUDGET:
        if stages > 1:
            stages -= 1
        elif bj > 16:
            bj //= 2
        elif bn > 16:
            bn //= 2
        else:
            break
    return bn, bj, stages


def _resolve_blocks(xy, d_pad, blocks, n_x, n_w):
    if blocks is None:
        bn, bj, warps, stages = _BLOCKS[d_pad]
    else:
        bn, bj, *rest = validate_blocks(blocks)
        warps, stages = rest or _BLOCKS[d_pad][2:]
    # shrink the node tile to tiny maps without dropping below 16
    bj = min(bj, _pow2_at_least(xy))
    bn, bj, stages = _fit_smem(bn, bj, stages, d_pad, n_x, n_w)
    return bn, bj, warps, stages


def searcher(
    w_flat,
    w_sq=None,
    *,
    center=None,
    mode="packed",
    top2=False,
    blocks=None,
    interpret=False,
    w_sq_raw=False,
):
    """Prepare the codebook operands once and return ``search(x)``.

    ``search(x)`` gives ``(idx, minval)`` of shapes ``(N,)`` int32 /
    ``(N,)`` float32, ``idx[n] = argmin_j(-2 x_n·w_j + ‖w_j‖²)`` and
    ``minval`` that partial squared distance (add ``‖x‖²`` for the full
    one). With ``top2=True`` it gives ``(idx, minval, idx2, minval2)``,
    the first two columns of a stable argsort of the distances (the
    reference's ``topographic_error`` selection, xpysom.py:731-734).
    Build the searcher outside a scan over chunks, so the codebook
    splits are computed once per codebook, not once per chunk.

    ``center``: optional (D,) translation subtracted from both operands.
    The distance is translation-invariant, but the split modes' error
    scales with the operand magnitudes, so centring on the codebook (the
    library passes its per-feature midrange, ``core.codebook_center``)
    shrinks it for data far from the origin. Values then shift by a
    per-sample constant; pass the SAME center wherever values are
    compared (e.g. across codebook shards).

    ``w_sq_raw=True`` declares that ``w_sq`` is a caller-defined per-node
    offset rather than ``Σw²`` (cosine rides the kernel with a zero one):
    ``split2`` then adds it as given instead of the rounded codebook's
    norm.

    ``blocks``: ``(BN, BJ[, num_warps, num_stages])`` override of the
    per-width default (``blocks_for``).
    """
    if mode not in MODES:
        raise ValueError(f"mode={mode!r} not recognized ({'|'.join(MODES)})")
    xy, d_dim = w_flat.shape
    if d_dim > MAX_D:
        raise ValueError(f"feature width {d_dim} > MAX_D={MAX_D}")
    w_flat = w_flat.astype(jnp.float32)
    if center is not None:
        w_flat = w_flat - center[None, :]
        if not w_sq_raw:
            w_sq = None  # the given norm is of the uncentred codebook
    if w_sq is None:
        w_sq = jnp.sum(jnp.square(w_flat), axis=1)
    w_sq = w_sq.reshape(xy).astype(jnp.float32)

    d_pad = _pow2_at_least(d_dim)
    n_x, n_w = {"packed": (2, 2), "split2": (2, 1), "bf16": (1, 1)}[mode]
    bn, bj, warps, stages = _resolve_blocks(xy, d_pad, blocks, n_x, n_w)
    xy_pad = -(-xy // bj) * bj
    w2 = _pad_to(_pad_to(-2.0 * w_flat, xy_pad, 0), d_pad, 1)
    if mode == "bf16":
        ws = (w2.astype(jnp.bfloat16),)
        pairs = ((0, 0),)
    else:
        wh, wl = _split_bf16(w2)
        if mode == "packed":
            ws = (wh, wl)
            pairs = ((1, 0), (0, 1), (0, 0))  # small terms first
        else:  # split2
            ws = (wh,)
            pairs = ((1, 0), (0, 0))
            if not w_sq_raw:
                # ‖w_h‖² of the rounded codebook (w_h = -wh/2), so the
                # distance is exact to the problem it solves
                w_sq = 0.25 * jnp.sum(
                    jnp.square(wh[:xy].astype(jnp.float32)), axis=1
                )
    wsq_p = _pad_to(w_sq, xy_pad, 0, jnp.inf)

    def search(x):
        n = x.shape[0]
        if x.shape[1] != d_dim:
            raise ValueError(f"x has {x.shape[1]} features, codebook {d_dim}")
        x = x.astype(jnp.float32)
        if center is not None:
            x = x - center[None, :]
        bn_n = min(bn, _pow2_at_least(n))
        n_pad = -(-n // bn_n) * bn_n
        x_p = _pad_to(_pad_to(x, n_pad, 0), d_pad, 1)
        xs = (x_p.astype(jnp.bfloat16),) if mode == "bf16" else _split_bf16(x_p)
        outs = _search(
            xs, ws, wsq_p, pairs, top2=top2,
            blocks=(bn_n, bj, warps, stages), interpret=interpret,
        )
        return tuple(o[:n] for o in outs)

    return search


def cosine_searcher(w_flat, **kwargs):
    """``searcher`` under the COSINE activation (reference
    distances.py:45-59 + argmin): values are cosine distances
    ``1 − x·w / (‖x‖‖w‖)``.

    Rides the euclidean kernel: with the row-normalised codebook ``ŵ/2``
    and a zero per-node offset the kernel computes ``−x·ŵ``, whose
    per-row argmin is the cosine argmin (``‖x‖`` is a positive per-row
    constant; zero rows reproduce the reference's ``nan_to_num``
    convention — all distances 1)."""
    xy = w_flat.shape[0]
    w_norm = jnp.sqrt(jnp.sum(jnp.square(w_flat), axis=1, keepdims=True))
    w_hat = jnp.where(w_norm > 0, w_flat / jnp.where(w_norm > 0, w_norm, 1.0), 0.0)
    inner = searcher(
        0.5 * w_hat, jnp.zeros((xy,), jnp.float32), w_sq_raw=True, **kwargs
    )

    def search(x):
        outs = inner(x)
        x_norm = jnp.sqrt(jnp.sum(jnp.square(x.astype(jnp.float32)), axis=1))
        # (idx, -x·ŵ) pairs -> (idx, cosine distance)
        return tuple(
            o if k % 2 == 0 else 1.0 - jnp.nan_to_num(-o / x_norm)
            for k, o in enumerate(outs)
        )

    return search


_STATIC = ("mode", "top2", "blocks", "interpret")


@partial(jax.jit, static_argnames=_STATIC + ("w_sq_raw",))
def bmu_euclidean(x, w_flat, w_sq=None, **kwargs):
    """One-shot ``searcher(w_flat, w_sq, **kwargs)(x)``."""
    return searcher(w_flat, w_sq, **kwargs)(x)


@partial(jax.jit, static_argnames=_STATIC)
def bmu_cosine(x, w_flat, **kwargs):
    """One-shot ``cosine_searcher(w_flat, **kwargs)(x)``."""
    return cosine_searcher(w_flat, **kwargs)(x)
