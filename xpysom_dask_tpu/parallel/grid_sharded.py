"""Codebook (grid) sharding: the tensor-parallel axis of the batch SOM.

The reference replicates the codebook everywhere (it is small:
xpysom.py:551; SURVEY.md §2.10 notes codebook sharding as the natural
extension beyond reference behavior). For very large grids (e.g. 512×512
× wide features) this module shards the *flattened grid axis* ``XY`` over
a ``'model'`` mesh axis, composing with ``'data'`` parallelism in a 2-D
mesh:

- **W layout**: ``w_flat (XY, D)`` sharded to ``(XY/k, D)`` per model
  shard; samples sharded over 'data', replicated over 'model'.
- **BMU search**: each model shard computes distances against its codebook
  rows only and a local argmin; the global winner is two tiny collectives
  over 'model' (a ``pmin`` of values, then a ``pmin`` of masked global
  indices — preserving NumPy's first-index tie-breaking).
- **Sufficient statistics**: each shard scatter-accumulates only the
  samples whose BMU lands in its row range → ``S``/``cnt`` arrive already
  sharded over 'model'; a ``psum`` over 'data' reduces across data shards.
- **Update**: statistics are ``all_gather``-ed over 'model' (XY·D per
  epoch — the only model-axis traffic proportional to the grid) and the
  neighborhood-operator update is computed once, each shard keeping its
  row slice.

Every collective rides the mesh (NVLink between the cards of a host),
with no host involvement — the same design rules as the data-parallel
path.
"""

from __future__ import annotations

from functools import lru_cache
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import SomSpec, _decays, _update_from_stats, scatter_sum
from ..ops.distances import DistanceFunction

_F32 = jnp.float32
_BIG_I32 = np.int32(2**31 - 1)

DATA_AXIS = "data"
MODEL_AXIS = "model"

__all__ = [
    "make_grid_mesh",
    "make_stats_fn_2d",
    "make_update_fn_2d",
    "make_epoch_fn_2d",
    "make_train_fn_2d",
    "make_bmu_fn_2d",
    "make_quantization_stats_fn_2d",
    "make_topographic_stats_fn_2d",
    "codebook_sharding",
    "is_grid_mesh",
]


def make_grid_mesh(n_data: int, n_model: int, devices=None) -> Mesh:
    """2-D mesh ``(data, model)`` over ``n_data * n_model`` devices."""
    if devices is None:
        devices = jax.devices()
    need = n_data * n_model
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(n_data, n_model)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def is_grid_mesh(mesh) -> bool:
    return isinstance(mesh, Mesh) and MODEL_AXIS in mesh.axis_names


def codebook_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for the (X, Y, D) codebook: X·Y rows split over 'model'.
    We shard the leading (X) axis — callers must pick X divisible by the
    model-axis size."""
    return NamedSharding(mesh, P(MODEL_AXIS))


def _local_rows(spec: SomSpec, n_model: int) -> int:
    # the codebook shards along X, so flat-index ranges stay contiguous
    if spec.x % n_model:
        raise ValueError(
            f"grid X={spec.x} must divide evenly over {n_model} model shards"
        )
    return spec.xy // n_model


def _global_center(w_flat_local):
    """``core.codebook_center`` of the FULL codebook, replicated over
    'model': the kernel's translation center must be identical on every
    shard so per-shard min values stay comparable in the pmin merge, and
    bit-identical to the unsharded center (min/max reduce exactly in any
    order) so sharded and unsharded searches agree to the last bit."""
    lo = jax.lax.pmin(jnp.min(w_flat_local, axis=0), MODEL_AXIS)
    hi = jax.lax.pmax(jnp.max(w_flat_local, axis=0), MODEL_AXIS)
    return 0.5 * (lo + hi)


def _shard_searcher(spec: SomSpec, dist: DistanceFunction, w_flat_local, top2=False):
    """``core.bmu_searcher`` over this shard's codebook rows. Values must
    be comparable ACROSS shards for the pmin merge: the euclidean kernel
    is centred by the per-feature midrange of the FULL codebook
    (``_global_center``: a pmin and a pmax over 'model', run only on that
    path), the cosine value 1−sim divides by
    the shard-invariant ``‖x‖``, and the XLA path's values are absolute."""
    from ..core import _pallas_bmu_kind, bmu_searcher

    kind = _pallas_bmu_kind(
        dist, spec.input_len, spec.use_pallas, spec.bmu_precision
    )
    center = _global_center(w_flat_local) if kind == "euclidean" else None
    w_sq = (
        jnp.sum(jnp.square(w_flat_local), axis=1, keepdims=True)
        if kind is None and dist.can_cache
        else None
    )
    return bmu_searcher(
        dist, w_flat_local, w_sq, spec, top2=top2, center=center
    )


def _global_bmu(local_min, local_arg, offset):
    """Global argmin from per-shard (min, argmin). Two pmin collectives
    over 'model'; first-index tie-breaking globally."""
    global_min = jax.lax.pmin(local_min, MODEL_AXIS)
    candidate = jnp.where(
        local_min == global_min, local_arg.astype(jnp.int32) + offset, _BIG_I32
    )
    return jax.lax.pmin(candidate, MODEL_AXIS), global_min


def _shard_stats(
    spec: SomSpec, dist: DistanceFunction, w_local, data, mask, split=None
):
    """Scan chunks; per chunk: sharded BMU search then scatter-accumulate
    into this shard's row range only. ``split`` selects the scatter
    formulation — factories resolve it eagerly at build time
    (core._use_split_scatter) so traced code never reads env; ``None``
    resolves at call time (direct/measurement callers)."""
    rows = w_local.shape[0]
    offset = jax.lax.axis_index(MODEL_AXIS) * rows
    search = _shard_searcher(spec, dist, w_local)
    d_dim = spec.input_len
    if split is None:
        from ..core import _use_split_scatter

        split = _use_split_scatter(d_dim)

    def body(carry, xs):
        x, m = xs
        larg, lmin = search(x)
        bmu, _ = _global_bmu(lmin, larg, offset)
        mine = (bmu >= offset) & (bmu < offset + rows)
        local_idx = jnp.clip(bmu - offset, 0, rows - 1)
        contrib = m * mine.astype(_F32)
        if split:
            # lane-boundary widths: separate S / cnt scatters, see
            # core._use_split_scatter
            s_acc, c_acc = carry
            s_part = scatter_sum(local_idx, x * contrib[:, None], rows)
            c_part = jnp.zeros((rows,), dtype=_F32).at[local_idx].add(contrib)
            return (s_acc + s_part, c_acc + c_part), None
        # fused [x | 1] scatter + fresh per-chunk partials: see
        # core._accumulate_stats (1.4× fewer serial scatter updates; f32
        # 2^24 increment-loss guard for huge-N)
        aug = (
            jnp.concatenate([x, jnp.ones((x.shape[0], 1), _F32)], axis=1)
            * contrib[:, None]
        )
        part = scatter_sum(local_idx, aug, rows)
        return carry + part, None

    if split:
        init = (
            jnp.zeros((rows, d_dim), dtype=_F32),
            jnp.zeros((rows,), dtype=_F32),
        )
        (s, cnt), _ = jax.lax.scan(body, init, (data, mask))
    else:
        init = jnp.zeros((rows, d_dim + 1), dtype=_F32)
        acc, _ = jax.lax.scan(body, init, (data, mask))
        s, cnt = acc[:, :d_dim], acc[:, d_dim]
    # reduce over data shards; stays sharded over model
    s = jax.lax.psum(s, DATA_AXIS)
    cnt = jax.lax.psum(cnt, DATA_AXIS)
    return s, cnt


def _gathered_update(spec: SomSpec, num_epochs: int, w_local, s_local, cnt_local, t):
    """The model-axis finalize protocol, shared by the epoch step and the
    streaming update fn (round-5 review: two verbatim copies could drift):
    gather full statistics over the model axis (the one XY-sized
    collective per epoch), compute the tiny update, keep local rows."""
    rows = w_local.shape[0] * w_local.shape[1]  # local X-rows * Y
    w_flat_local = w_local.reshape(rows, spec.input_len)
    eta, sig = _decays(spec, t, num_epochs)
    s = jax.lax.all_gather(s_local, MODEL_AXIS, axis=0, tiled=True)
    cnt = jax.lax.all_gather(cnt_local, MODEL_AXIS, axis=0, tiled=True)
    w_flat = jax.lax.all_gather(w_flat_local, MODEL_AXIS, axis=0, tiled=True)
    new_flat = _update_from_stats(spec, w_flat, s, cnt, eta, sig)
    offset = jax.lax.axis_index(MODEL_AXIS) * rows
    new_local = jax.lax.dynamic_slice_in_dim(new_flat, offset, rows, axis=0)
    return new_local.reshape(w_local.shape)


def _make_step_2d(spec: SomSpec, num_epochs: int):
    dist = spec.distance_fn()
    from ..core import _use_split_scatter

    split = _use_split_scatter(spec.input_len)  # eager, at build time

    def step(w_local, data, mask, t):
        rows = w_local.shape[0] * w_local.shape[1]  # local X-rows * Y
        w_flat_local = w_local.reshape(rows, spec.input_len)
        s_local, cnt_local = _shard_stats(
            spec, dist, w_flat_local, data, mask, split=split
        )
        return _gathered_update(spec, num_epochs, w_local, s_local, cnt_local, t)

    return step


def _in_specs():
    return (P(MODEL_AXIS), P(DATA_AXIS), P(DATA_AXIS), P())


@lru_cache(maxsize=32)
def make_epoch_fn_2d(spec: SomSpec, num_epochs: int, mesh: Mesh):
    """One training epoch on a (data, model) mesh:
    ``epoch(w, data, mask, t) -> w'`` with ``w (X, Y, D)`` sharded over X
    and data chunks sharded over the data axis."""
    _local_rows(spec, mesh.shape[MODEL_AXIS])
    step = _make_step_2d(spec, num_epochs)
    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=_in_specs(),
        out_specs=P(MODEL_AXIS),
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(0,))


@lru_cache(maxsize=32)
def make_train_fn_2d(spec: SomSpec, num_epochs: int, mesh: Mesh):
    """Whole-run on-device epoch loop on a (data, model) mesh."""
    _local_rows(spec, mesh.shape[MODEL_AXIS])
    step = _make_step_2d(spec, num_epochs)

    def run(w_local, data, mask, iter_beg, iter_end):
        def body(t, w):
            return step(w, data, mask, t)

        return jax.lax.fori_loop(iter_beg, iter_end, body, w_local)

    sharded = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(P(MODEL_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(), P()),
        out_specs=P(MODEL_AXIS),
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(0,))


@lru_cache(maxsize=32)
def make_stats_fn_2d(spec: SomSpec, mesh: Mesh):
    """Accumulate-only half of an epoch on a (data, model) mesh:
    ``stats(w, data, mask) -> (S, cnt)`` with the statistics sharded over
    'model' (used by the streaming pipeline)."""
    _local_rows(spec, mesh.shape[MODEL_AXIS])
    dist = spec.distance_fn()
    from ..core import _use_split_scatter

    split = _use_split_scatter(spec.input_len)  # eager, at build time

    def run(w_local, data, mask):
        rows = w_local.shape[0] * w_local.shape[1]
        w_flat_local = w_local.reshape(rows, spec.input_len)
        return _shard_stats(spec, dist, w_flat_local, data, mask, split=split)

    sharded = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(P(MODEL_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(MODEL_AXIS), P(MODEL_AXIS)),
        check_vma=False,
    )
    return jax.jit(sharded)


@lru_cache(maxsize=32)
def make_update_fn_2d(spec: SomSpec, num_epochs: int, mesh: Mesh):
    """Finalize half of an epoch on a (data, model) mesh:
    ``update(w, S, cnt, t) -> w'`` with w and stats sharded over 'model'."""
    _local_rows(spec, mesh.shape[MODEL_AXIS])

    def run(w_local, s_local, cnt_local, t):
        return _gathered_update(spec, num_epochs, w_local, s_local, cnt_local, t)

    sharded = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(P(MODEL_AXIS), P(MODEL_AXIS), P(MODEL_AXIS), P()),
        out_specs=P(MODEL_AXIS),
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(0,))


@lru_cache(maxsize=32)
def make_bmu_fn_2d(spec: SomSpec, mesh: Mesh):
    """Sharded winner search: ``bmu(w, data) -> (C, chunk) int32`` global
    flat indices (replicated output)."""
    _local_rows(spec, mesh.shape[MODEL_AXIS])
    dist = spec.distance_fn()

    def run(w_local, data):
        rows = w_local.shape[0] * w_local.shape[1]
        w_flat_local = w_local.reshape(rows, spec.input_len)
        offset = jax.lax.axis_index(MODEL_AXIS) * rows
        search = _shard_searcher(spec, dist, w_flat_local)

        def body(_, x):
            larg, lmin = search(x)
            bmu, _ = _global_bmu(lmin, larg, offset)
            return None, bmu.astype(jnp.int32)

        _, bmu = jax.lax.scan(body, None, data)
        return bmu

    sharded = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(P(MODEL_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )
    return jax.jit(sharded)


def _lexmin(vals, idxs):
    """Per-row (min value, smallest index attaining it) — the NumPy-argmin
    first-index tie-break, vectorized over a candidate axis."""
    v = jnp.min(vals, axis=1)
    i = jnp.min(jnp.where(vals == v[:, None], idxs, _BIG_I32), axis=1)
    return v, i


@lru_cache(maxsize=32)
def make_topographic_stats_fn_2d(spec: SomSpec, mesh: Mesh):
    """Sharded topographic-error statistics (reference xpysom.py:709-746):
    ``(w, data, mask) -> (Σ errors, Σ mask)``.

    Global top-2 BMUs from a codebook sharded over 'model': each shard
    takes its local top-2 (``lax.top_k``), the ``2·k`` candidates are
    ``all_gather``-ed over 'model' (a (chunk, 2k) tensor — tiny), and the
    global top-2 are selected by two lexicographic (value, index) min
    passes, preserving first-index tie-breaking exactly as the
    single-device path. Adjacency semantics match
    ``core.make_topographic_stats_fn``.

    The per-shard search is ``core.te_spec``'s top-2 search (the fused
    kernel on the GPU); its stable-argsort top-2 feeds the same
    lexicographic merge on every path."""
    from ..core import grid_coordinates, te_spec

    n_model = mesh.shape[MODEL_AXIS]
    rows = _local_rows(spec, n_model)
    if rows < 2:
        raise ValueError(
            f"topographic_error needs ≥2 codebook rows per model shard "
            f"(got {rows}); use fewer model shards"
        )
    if spec.topology == "hexagonal" and spec.x != spec.y:
        raise ValueError(
            "topographic_error on hexagonal topology requires a square map "
            f"(got {spec.x}x{spec.y}); the reference's coordinate indexing "
            "(xpysom.py:742-743) is undefined for non-square hex maps"
        )
    eucl = DistanceFunction("euclidean")
    te = te_spec(spec)
    xx_np, yy_np = grid_coordinates(spec.x, spec.y, spec.topology)
    xx = jnp.asarray(xx_np, _F32)
    yy = jnp.asarray(yy_np, _F32)

    def run(w_local, data, mask):
        w_flat_local = w_local.reshape(rows, spec.input_len)
        offset = jax.lax.axis_index(MODEL_AXIS) * rows
        search = _shard_searcher(te, eucl, w_flat_local, top2=True)

        def body(carry, xs):
            errs, n = carry
            x, m = xs
            i1l, v1l, i2l, v2l = search(x)  # local top-2, stable
            vals2 = jnp.stack([v1l, v2l], axis=1)
            idxs2 = jnp.stack([i1l, i2l], axis=1) + offset
            # (chunk, 2) per shard -> (chunk, 2k) candidates, then two
            # lexicographic min passes for the global (top1, top2)
            vals = jax.lax.all_gather(vals2, MODEL_AXIS, axis=1, tiled=True)
            idxs = jax.lax.all_gather(idxs2, MODEL_AXIS, axis=1, tiled=True)
            v1, i1 = _lexmin(vals, idxs)
            vals_wo = jnp.where(idxs == i1[:, None], jnp.inf, vals)
            _, i2 = _lexmin(vals_wo, idxs)
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
        return jax.lax.psum(errs, DATA_AXIS), jax.lax.psum(n, DATA_AXIS)

    sharded = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(P(MODEL_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


@lru_cache(maxsize=32)
def make_quantization_stats_fn_2d(spec: SomSpec, mesh: Mesh):
    """Sharded quantization-error statistics (euclidean BMU like the
    reference, xpysom.py:632-645): ``(w, data, mask) -> (Σ err, Σ mask)``."""
    _local_rows(spec, mesh.shape[MODEL_AXIS])
    eucl = DistanceFunction("euclidean")

    def run(w_local, data, mask):
        rows = w_local.shape[0] * w_local.shape[1]
        w_flat_local = w_local.reshape(rows, spec.input_len)
        offset = jax.lax.axis_index(MODEL_AXIS) * rows
        search = _shard_searcher(spec, eucl, w_flat_local)

        def body(carry, xs):
            tot, n = carry
            x, m = xs
            larg, lmin = search(x)
            bmu, _ = _global_bmu(lmin, larg, offset)
            mine = (bmu >= offset) & (bmu < offset + rows)
            local_idx = jnp.clip(bmu - offset, 0, rows - 1)
            err_local = jnp.linalg.norm(x - w_flat_local[local_idx], axis=1)
            # accumulate the shard-local masked error; one model-axis psum
            # after the scan instead of one per chunk
            return (
                tot + jnp.sum(err_local * mine.astype(_F32) * m),
                n + jnp.sum(m),
            ), None

        (tot, n), _ = jax.lax.scan(
            body, (jnp.float32(0), jnp.float32(0)), (data, mask)
        )
        tot = jax.lax.psum(tot, MODEL_AXIS)
        return jax.lax.psum(tot, DATA_AXIS), jax.lax.psum(n, DATA_AXIS)

    sharded = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(P(MODEL_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)
