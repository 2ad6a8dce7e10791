"""Population training: P same-shape SOMs behind one model-selection API.

A beyond-reference capability (no counterpart in ``xpysom_dask``): the
standard SOM model-selection workflow — train many maps that differ only
in random seed, σ schedule, or learning-rate schedule, then keep the one
with the lowest quantization error (Kohonen's recommended practice) — runs
serially in the reference, once per candidate
(``xpysom_dask/xpysom.py:458-594`` per candidate).

Three execution strategies, selected by ``train(strategy=...)``:

- ``'serial'`` (the ``'auto'`` choice for resident data): each member
  trains through the single-model fast path — the fused BMU kernel on the
  GPU, one whole-run ``core.make_train_fn`` executable per distinct
  schedule (a seed-only sweep compiles ONCE and reuses the executable for
  every member; the chunked data stays device-resident across members).

- ``'fused'`` (the ``'auto'`` choice for streaming sources up to
  ``_FUSED_STREAM_MAX_NODES`` stacked nodes): ``lax.map`` over the
  stacked ``(P, XY, D)`` codebooks with the single-model stats body
  inside — per-member BMU searches like 'serial', but the whole
  population fold is ONE executable and ONE dispatch per superbatch like
  'batched', and a streaming source is read ONCE per epoch regardless
  of P.

- ``'batched'``: stack the P codebooks into ONE ``(P·XY, D)`` matrix so
  the BMU search of every member is a single concatenated GEMM per data
  chunk (``(chunk, D) @ (D, P·XY)``), per-member winners via a block
  argmin over the reshaped ``(chunk, P, XY)`` distances, one vmapped
  scatter-add into per-member sufficient statistics, per-member traced
  ``(η_t, σ_t)`` under ``jax.vmap``; the whole P-member multi-epoch
  sweep is ONE ``lax.fori_loop`` executable.

The batched program keeps the block argmin off the fused BMU kernel
(the kernel computes one global argmin), and materialises the
``(chunk, P·XY)`` distance matrix. Which program is fastest on the GPU
at which sizes is not measured yet (ROADMAP); the 'auto' routing is
carried over from measurements on another accelerator.

Per-member knobs: ``random_seed``, ``sigma``, ``sigmaN``,
``learning_rate``, ``learning_rateN`` (scalar = shared, length-P sequence =
per member). Everything that shapes the compiled computation — grid size,
topology, neighborhood, decay family, activation distance — is shared
across the population (that is what makes the batched program one program).

Members are real ``XPySom`` objects: ``member(i)`` (or ``best(data)``)
returns a fully-functional model — predict/distance_map/serialization all
work — whose weights are the population-trained codebook.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Union
from warnings import warn

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P_, Mesh

from .. import core
from ..core import SomSpec, chunk_data
from ..ops.decays import DECAY_REGISTRY
from ..ops.distances import DistanceFunction, euclidean_squared_distance_part
from ..parallel.mesh import data_sharding, replicated_sharding, resolve_mesh
from ..utils.hw import default_n_parallel, training_chunk
from ..utils.progress import ProgressReporter
from .som import XPySom, _as_numpy_2d

__all__ = ["SomPopulation"]

_F32 = jnp.float32

# Streaming-'auto' routing gate: the fused lax.map-over-members program
# for stacked codebooks up to this many nodes (P·X·Y), the concatenated
# GEMM beyond. The crossover was measured on another accelerator at
# 24×24×16 maps only; it is not measured on the GPU yet (ROADMAP).
# Model-selection sweeps live far below it (P=16 of 24×24 maps = 9.2k),
# so 'auto' rides the fused program in practice.
_FUSED_STREAM_MAX_NODES = 32768


def _streaming_auto_impl(total_nodes):
    """Streaming ``strategy='auto'`` program choice for a ``total_nodes``
    = P·X·Y stacked codebook (gate rationale above)."""
    return "fused" if total_nodes <= _FUSED_STREAM_MAX_NODES else "concat"


def _pop_decays(specs, t, num_epochs):
    """Per-member (η_t, σ_t) from each member's *static* schedule and the
    traced epoch index ``t``. Unrolls over members at trace time (P is
    small), keeping the decay functions' Python-level ``valN == 0``
    branches intact (ops/decays.py)."""
    decay = DECAY_REGISTRY[specs[0].decay]
    eta = jnp.stack(
        [decay(s.learning_rate, s.learning_rateN, t, num_epochs) for s in specs]
    )
    sig = jnp.stack([decay(s.sigma, s.sigmaN, t, num_epochs) for s in specs])
    return eta, sig


def _make_pop_stats(specs, psum_axis=None):
    """Pure accumulate-only half of a population epoch:
    ``stats(w, data, mask) -> (S (P, XY, D), cnt (P, XY))`` — the
    concatenated-codebook BMU GEMM + vmapped scatter, psum-reduced over
    ``psum_axis`` when given (for use under ``shard_map``)."""
    spec0 = specs[0]
    n_pop = len(specs)
    xy = spec0.xy
    d_dim = spec0.input_len
    dist = spec0.distance_fn()
    split = core._use_split_scatter(d_dim)  # eager, at build time

    def stats(w, data, mask):
        w_big = w.reshape(n_pop * xy, d_dim)
        w_sq = (
            jnp.sum(jnp.square(w_big), axis=1, keepdims=True)
            if dist.can_cache
            else None
        )

        def body(carry, xs):
            x, m = xs
            # one GEMM covers every member's distance matrix
            dmat = dist.flat(x, w_big, w_sq)  # (chunk, P·XY)
            bmu = jnp.argmin(
                dmat.reshape(x.shape[0], n_pop, xy), axis=2
            )  # (chunk, P), first-index ties like the single-model path
            if split:
                # lane-boundary widths: separate S / cnt scatters, see
                # core._use_split_scatter
                s_acc, c_acc = carry
                xm = x * m[:, None]
                s_part = jax.vmap(lambda b: core.scatter_sum(b, xm, xy))(bmu.T)
                c_part = jax.vmap(
                    lambda b: jnp.zeros((xy,), _F32).at[b].add(m)
                )(bmu.T)
                return (s_acc + s_part, c_acc + c_part), None
            aug = (
                jnp.concatenate([x, jnp.ones((x.shape[0], 1), _F32)], axis=1)
                * m[:, None]
            )
            part = jax.vmap(lambda b: core.scatter_sum(b, aug, xy))(bmu.T)
            return carry + part, None

        if split:
            init = (
                jnp.zeros((n_pop, xy, d_dim), dtype=_F32),
                jnp.zeros((n_pop, xy), dtype=_F32),
            )
            (s, cnt), _ = jax.lax.scan(body, init, (data, mask))
            if psum_axis is not None:
                s = jax.lax.psum(s, psum_axis)
                cnt = jax.lax.psum(cnt, psum_axis)
        else:
            init = jnp.zeros((n_pop, xy, d_dim + 1), dtype=_F32)
            acc, _ = jax.lax.scan(body, init, (data, mask))
            if psum_axis is not None:
                acc = jax.lax.psum(acc, psum_axis)
            s, cnt = acc[..., :d_dim], acc[..., d_dim]
        return s, cnt

    return stats


def _make_pop_stats_fused(specs, psum_axis=None):
    """Per-member sufficient statistics via ``lax.map`` over the stacked
    codebooks with the single-model stats body inside: each member's BMU
    search is the single-model search (the fused kernel on the GPU), yet
    the whole population fold is ONE dispatch per superbatch like the
    concatenated program, and it serves streaming sources with a single
    pass over the data."""
    spec0 = specs[0]
    n_pop = len(specs)
    xy = spec0.xy
    d_dim = spec0.input_len
    dist = spec0.distance_fn()
    # scatter-formulation env hook resolved eagerly at build time, like
    # core.make_epoch_step — the traced program never reads env
    split = core._use_split_scatter(d_dim)

    def stats(w, data, mask):
        def member(w_i):
            w_flat = w_i.reshape(xy, d_dim)
            w_sq = (
                jnp.sum(jnp.square(w_flat), axis=1, keepdims=True)
                if dist.can_cache
                else None
            )
            return core._accumulate_stats(
                dist, w_flat, w_sq, data, mask, xy, spec0, split_scatter=split
            )

        s, cnt = jax.lax.map(member, w.reshape(n_pop, xy, d_dim))
        if psum_axis is not None:
            s = jax.lax.psum(s, psum_axis)
            cnt = jax.lax.psum(cnt, psum_axis)
        return s, cnt

    return stats


def _pop_update(specs, num_epochs: int):
    """Pure finalize half: ``update(w, s, cnt, t) -> w'`` — per-member
    traced decays + vmapped neighborhood update."""
    spec0 = specs[0]

    def update(w, s, cnt, t):
        eta, sig = _pop_decays(specs, t, num_epochs)
        upd = jax.vmap(
            lambda wf, si, ci, e, g: core._update_from_stats(spec0, wf, si, ci, e, g)
        )
        return upd(w, s, cnt, eta, sig)

    return update


def _make_pop_epoch_step(specs, num_epochs: int, psum_axis=None, stats_impl="concat"):
    """Pure epoch step over the stacked population codebook:
    ``step(w, data, mask, t) -> w'`` with ``w`` of shape ``(P, XY, D)``.
    ``stats_impl``: 'concat' = the concatenated-codebook GEMM program,
    'fused' = ``lax.map`` over members with the fused single-model body."""
    builder = _make_pop_stats_fused if stats_impl == "fused" else _make_pop_stats
    stats = builder(specs, psum_axis)
    update = _pop_update(specs, num_epochs)

    def step(w, data, mask, t):
        s, cnt = stats(w, data, mask)
        return update(w, s, cnt, t)

    return step


@lru_cache(maxsize=32)
def make_population_stats_fn(
    specs, mesh: Optional[Mesh] = None, stats_impl: str = "concat"
):
    """Compile the accumulate-only half of a population epoch (used by the
    streaming path to fold superbatches, mirroring ``core.make_stats_fn``);
    with a mesh the shard partials are psum-reduced so the result is
    replicated. ``stats_impl='fused'`` selects the lax.map-over-members
    fused program (``_make_pop_stats_fused``)."""
    builder = _make_pop_stats_fused if stats_impl == "fused" else _make_pop_stats
    stats = builder(specs, psum_axis="data" if mesh is not None else None)
    if mesh is None:
        return jax.jit(stats)
    sharded = jax.shard_map(
        stats,
        mesh=mesh,
        in_specs=(P_(), P_("data"), P_("data")),
        out_specs=(P_(), P_()),
        check_vma=False,
    )
    return jax.jit(sharded)


@lru_cache(maxsize=32)
def make_population_update_fn(specs, num_epochs: int):
    """Compile the finalize half: ``update(w, s, cnt, t) -> w'`` (tiny,
    runs replicated — mirrors ``core.make_update_fn``)."""
    return jax.jit(_pop_update(specs, num_epochs), donate_argnums=(0,))


@lru_cache(maxsize=32)
def make_population_epoch_fn(
    specs, num_epochs: int, mesh: Optional[Mesh] = None, stats_impl: str = "concat"
):
    """Compile one population epoch: ``epoch(w, data, mask, t) -> w'``."""
    if mesh is None:
        return jax.jit(
            _make_pop_epoch_step(specs, num_epochs, stats_impl=stats_impl),
            donate_argnums=(0,),
        )
    step = _make_pop_epoch_step(
        specs, num_epochs, psum_axis="data", stats_impl=stats_impl
    )
    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P_(), P_("data"), P_("data"), P_()),
        out_specs=P_(),
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(0,))


@lru_cache(maxsize=32)
def make_population_train_fn(
    specs, num_epochs: int, mesh: Optional[Mesh] = None, stats_impl: str = "concat"
):
    """Compile a whole population sweep:
    ``train(w, data, mask, iter_beg, iter_end) -> w'`` — every member, every
    epoch, one executable (mirrors ``core.make_train_fn``)."""
    psum_axis = "data" if mesh is not None else None
    step = _make_pop_epoch_step(
        specs, num_epochs, psum_axis=psum_axis, stats_impl=stats_impl
    )

    def run(w, data, mask, iter_beg, iter_end):
        def body(t, w):
            return step(w, data, mask, t)

        return jax.lax.fori_loop(iter_beg, iter_end, body, w)

    if mesh is None:
        return jax.jit(run, donate_argnums=(0,))
    sharded = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(P_(), P_("data"), P_("data"), P_(), P_()),
        out_specs=P_(),
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(0,))


@lru_cache(maxsize=32)
def make_population_qe_fn(spec0: SomSpec, n_pop: int, mesh: Optional[Mesh] = None):
    """Compile per-member quantization-error statistics:
    ``qstats(w, data, mask) -> (Σ‖x − W_p[bmu_p]‖ per member, Σ mask)``.
    BMU by *euclidean* distance regardless of the activation distance, like
    the single-model path (reference rule, xpysom.py:632-645)."""
    xy = spec0.xy
    d_dim = spec0.input_len

    def run(w, data, mask):
        w_big = w.reshape(n_pop * xy, d_dim)
        w_sq = jnp.sum(jnp.square(w_big), axis=1, keepdims=True)

        def body(carry, xs):
            tot, n = carry
            x, m = xs
            dmat = euclidean_squared_distance_part(x, w_big, w_sq)
            bmu = jnp.argmin(dmat.reshape(x.shape[0], n_pop, xy), axis=2)
            res = jax.vmap(lambda wp, bp: x - wp[bp], in_axes=(0, 1))(w, bmu)
            err = jnp.linalg.norm(res, axis=2)  # (P, chunk)
            return (tot + jnp.sum(err * m[None, :], axis=1), n + jnp.sum(m)), None

        init = (jnp.zeros((n_pop,), _F32), jnp.float32(0))
        (tot, n), _ = jax.lax.scan(body, init, (data, mask))
        if mesh is not None:
            tot = jax.lax.psum(tot, "data")
            n = jax.lax.psum(n, "data")
        return tot, n

    if mesh is None:
        return jax.jit(run)
    sharded = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(P_(), P_("data"), P_("data")),
        out_specs=(P_(), P_()),
        check_vma=False,
    )
    return jax.jit(sharded)


def _broadcast(value, n, name):
    """Scalar → length-n list; sequence → validated length-n list."""
    if np.ndim(value) == 0:
        return [value] * n
    seq = list(value)
    if len(seq) != n:
        raise ValueError(
            f"{name} must be a scalar or a length-{n} sequence, got length "
            f"{len(seq)}"
        )
    return seq


class SomPopulation:
    """P same-shape SOMs trained concurrently in one compiled program.

    Per-member arguments (``sigma``, ``sigmaN``, ``learning_rate``,
    ``learning_rateN``, ``random_seed``) accept a scalar (shared) or a
    length-``n_members`` sequence. An int ``random_seed`` seeds member i
    with ``random_seed + i`` so members start from distinct codebooks.
    All other arguments match ``XPySom`` and are shared.

    Typical model-selection sweep::

        pop = SomPopulation(16, 24, 24, d, sigma=sigmas, random_seed=0)
        pop.train(data, 10)
        som = pop.best(data)        # lowest-QE member, a normal XPySom
    """

    def __init__(
        self,
        n_members,
        x,
        y,
        input_len,
        sigma=0,
        sigmaN=1,
        learning_rate=0.5,
        learning_rateN=0.01,
        decay_function="exponential",
        neighborhood_function="gaussian",
        std_coeff=0.5,
        topology="rectangular",
        activation_distance="euclidean",
        activation_distance_kwargs={},
        random_seed=None,
        n_parallel=0,
        compact_support=False,
        mesh=None,
    ):
        if not isinstance(n_members, (int, np.integer)) or n_members < 1:
            raise ValueError(f"n_members must be a positive int, got {n_members!r}")
        self._n_members = int(n_members)

        sigmas = _broadcast(sigma, n_members, "sigma")
        sigmaNs = _broadcast(sigmaN, n_members, "sigmaN")
        lrs = _broadcast(learning_rate, n_members, "learning_rate")
        lrNs = _broadcast(learning_rateN, n_members, "learning_rateN")
        if random_seed is None or np.ndim(random_seed) == 0:
            base = random_seed
            seeds = [None if base is None else int(base) + i for i in range(n_members)]
        else:
            seeds = _broadcast(random_seed, n_members, "random_seed")

        # Budget the STACKED-program training chunk against the
        # CONCATENATED (chunk, P·XY) distance matrix — the per-chunk
        # transient the 'batched' plan materializes. Members keep the
        # USER's value: auto (0) members self-size exactly like a
        # standalone XPySom (fused per-member budget), so the 'serial'
        # plan — which never builds the concatenated matrix — trains
        # each member with the single-model fast path's own chunk
        # instead of the ~64x smaller concat-budgeted one (round-5
        # review finding).
        self._n_parallel_explicit = n_parallel != 0
        member_n_parallel = n_parallel
        if n_parallel == 0:
            n_parallel = default_n_parallel(self._n_members * x * y, fused=False)

        # Each member is a real XPySom: construction validates every shared
        # argument with the reference's ValueErrors and reproduces the
        # reference's per-seed random init exactly (som.py random init).
        self._members_list = [
            XPySom(
                x,
                y,
                input_len,
                sigma=sigmas[i],
                sigmaN=sigmaNs[i],
                learning_rate=lrs[i],
                learning_rateN=lrNs[i],
                decay_function=decay_function,
                neighborhood_function=neighborhood_function,
                std_coeff=std_coeff,
                topology=topology,
                activation_distance=activation_distance,
                activation_distance_kwargs=activation_distance_kwargs,
                random_seed=seeds[i],
                n_parallel=member_n_parallel,
                compact_support=compact_support,
            )
            for i in range(n_members)
        ]
        self._x, self._y, self._input_len = x, y, input_len
        self._n_parallel = int(n_parallel)

        self._mesh = resolve_mesh(mesh)
        if self._mesh is not None and "model" in self._mesh.axis_names:
            raise ValueError(
                "SomPopulation supports 1-D data-parallel meshes only "
                "(a 'data' axis); grid-sharded (data, model) meshes apply "
                "to single large maps via XPySom(mesh=...)"
            )

    # -- population state ----------------------------------------------------

    @property
    def n_members(self) -> int:
        return self._n_members

    @property
    def members(self) -> Sequence[XPySom]:
        """The live member models (views, not copies)."""
        return list(self._members_list)

    def member(self, i: int) -> XPySom:
        return self._members_list[i]

    @property
    def weights(self) -> np.ndarray:
        """Stacked member codebooks, shape ``(P, X, Y, D)``."""
        return np.stack(
            [np.asarray(m._weights, dtype=np.float32) for m in self._members_list]
        )

    def _specs(self):
        return tuple(m._spec for m in self._members_list)

    def _stacked_device_weights(self):
        from ..parallel.mesh import put_with_sharding

        w = self.weights.reshape(
            self._n_members, self._x * self._y, self._input_len
        )
        if self._mesh is not None:
            return put_with_sharding(w, replicated_sharding(self._mesh))
        return jnp.asarray(w)

    def _stats_n_parallel(self, stats_impl: str) -> int:
        """Chunk budget for a stacked-program strategy: 'concat'
        materializes the concatenated ``(chunk, P·XY)`` distance matrix,
        so it takes the population-level budget; 'fused' runs the
        per-member fused Pallas kernels inside ``lax.map`` and never
        builds that matrix, so it takes the MEMBER's budget (identical
        across members) — the same round-5 finding that member-sized the
        'serial' plan applies to 'fused' (a concat-sized chunk paid ~16×
        the per-chunk dispatch overhead for no memory win)."""
        if stats_impl == "fused":
            return self._members_list[0]._n_parallel
        return self._n_parallel

    def _chunked(
        self, data2d: np.ndarray, stats_impl: str = "concat", bucket=False
    ):
        from ..parallel.mesh import put_with_sharding
        from ..utils.hw import inference_chunk

        n = data2d.shape[0]
        min_chunks = 1
        if bucket:
            # INFERENCE paths (streaming quantization_errors): the shared
            # bucketed ladder bounds the compiled-shape class across
            # varying superbatch tails, like XPySom._chunked(bucket=True)
            chunk, min_chunks = inference_chunk(
                n, self._stats_n_parallel(stats_impl)
            )
        else:
            # shared training-branch sizing (utils.hw.training_chunk): the
            # 1024 sample-tile floor matters for strategy='fused' (Pallas
            # kernel inside lax.map — unaligned chunks blow compile time)
            # and is harmless for 'batched' (stays under the budget)
            chunk = training_chunk(n, self._stats_n_parallel(stats_impl))
        n_shards = 1 if self._mesh is None else self._mesh.devices.size
        chunks, mask, _ = chunk_data(
            data2d, chunk, multiple_of=n_shards, min_chunks=min_chunks
        )
        if self._mesh is not None:
            # resident data: identical on every process, multi-process-safe
            sh = data_sharding(self._mesh)
            return (
                put_with_sharding(chunks, sh),
                put_with_sharding(mask, sh),
                n,
            )
        return jnp.asarray(chunks), jnp.asarray(mask), n

    def _write_back(self, w):
        from ..parallel.mesh import fetch_global

        w_host = fetch_global(w).astype(np.float32, copy=False)
        for i, m in enumerate(self._members_list):
            m._weights = w_host[i].reshape(self._x, self._y, self._input_len)

    def _write_back_list(self, ws):
        for m, w in zip(self._members_list, ws):
            m._weights = np.asarray(
                jax.device_get(w), dtype=np.float32
            ).reshape(self._x, self._y, self._input_len)

    # -- training / evaluation ------------------------------------------------

    def train(
        self,
        data,
        num_epochs,
        iter_beg=0,
        iter_end=None,
        verbose=False,
        checkpoint_path=None,
        checkpoint_every=0,
        strategy="auto",
    ):
        """Train every member on ``data`` for epochs ``[iter_beg, iter_end)``
        of a ``num_epochs`` schedule.

        ``strategy`` selects the execution plan (module docstring):

        - ``'serial'``: members train one at a time through the
          single-model fast path (one whole-run executable per distinct
          schedule, reused across members; the chunked data stays on
          device across members). Not available for streaming sources.
        - ``'fused'``: ``lax.map`` over the stacked member codebooks with
          the single-model stats body inside — serial's per-member
          searches AND batched's one-executable/one-dispatch property,
          and a single pass over streaming sources.
        - ``'batched'``: the concatenated-codebook program (one GEMM
          covers every member's search).
        - ``'auto'`` (default): ``'serial'`` for resident data; for
          streaming sources ``'fused'`` while the stacked codebook is
          ≤ ``_FUSED_STREAM_MAX_NODES`` nodes, else ``'batched'``.

        Either strategy trains the same math per member; programs differ,
        so compare across strategies by quantization error, not bitwise
        weights (docs/MIGRATION.md, behavioral delta 7). Checkpoints are
        strategy-agnostic: both write the same epoch-synchronized
        population ``.npz``, and a resume may switch strategies.

        ``checkpoint_path`` + ``checkpoint_every=k`` write a portable
        population ``.npz`` checkpoint every k epochs (and at the end) —
        the same fault-tolerance mechanism as single-model
        ``XPySom.train``: after a failure,
        ``SomPopulation.load_checkpoint(path)`` and
        ``train(data, num_epochs, iter_beg=pop._checkpoint_epoch)``
        resume the sweep exactly (RNG state included).

        Source-like ``data`` (anything with ``superbatches`` or an
        ``np.memmap``) streams out-of-core, like single-model ``train``:
        per epoch the population statistics fold over superbatches, then
        one vmapped update runs — identical math to the resident path."""
        if checkpoint_every < 0:
            raise ValueError(
                f"checkpoint_every={checkpoint_every} must be >= 0"
            )
        if strategy not in ("auto", "batched", "serial", "fused"):
            raise ValueError(
                f"strategy={strategy!r} must be 'auto', 'batched', "
                "'serial' or 'fused'"
            )
        if iter_end is None:
            iter_end = num_epochs
        if hasattr(data, "superbatches") or isinstance(data, np.memmap):
            if strategy == "serial":
                raise ValueError(
                    "strategy='serial' would re-read the dataset once per "
                    "member; streaming sources make a single pass that "
                    "serves every member — use strategy='auto' (or "
                    "'fused': serial's per-member fused kernels in one "
                    "pass) for source-like data"
                )
            if strategy == "batched":
                impl = "concat"
            elif strategy == "fused":
                impl = "fused"
            else:
                # 'auto': route by the stacked-codebook size
                impl = _streaming_auto_impl(
                    self._n_members * self._x * self._y
                )
            return self._train_streaming(
                data, num_epochs, iter_beg, iter_end, verbose,
                checkpoint_path, checkpoint_every, stats_impl=impl,
            )
        data2d = _as_numpy_2d(data)
        if data2d.shape[1] != self._input_len:
            raise ValueError(
                "Received %d features, expected %d."
                % (data2d.shape[1], self._input_len)
            )
        if strategy in ("auto", "serial"):
            self._train_serial(
                data2d, num_epochs, iter_beg, iter_end, verbose,
                checkpoint_path, checkpoint_every,
            )
            if verbose:
                print(
                    "\n quantization errors:",
                    self.quantization_errors(data2d),
                )
            return self
        stats_impl = "fused" if strategy == "fused" else "concat"
        chunks, mask, n = self._chunked(data2d, stats_impl)
        w = self._stacked_device_weights()
        specs = self._specs()
        ckpt = bool(checkpoint_every and checkpoint_path)

        if verbose:
            epoch_fn = make_population_epoch_fn(
                specs, num_epochs, self._mesh, stats_impl
            )
            reporter = ProgressReporter(num_epochs * n)
            reporter.start()
            for t in range(iter_beg, iter_end):
                w = epoch_fn(w, chunks, mask, jnp.int32(t))
                reporter.update(t * n + n - 1)
                if ckpt and (
                    (t + 1 - iter_beg) % checkpoint_every == 0
                    or t + 1 == iter_end
                ):
                    self._write_back(w)
                    self.save_checkpoint(checkpoint_path, epoch=t + 1)
        else:
            # whole sweep in one executable per checkpoint segment (data
            # and codebooks stay on device across segments)
            train_fn = make_population_train_fn(
                specs, num_epochs, self._mesh, stats_impl
            )
            seg = checkpoint_every if ckpt else (iter_end - iter_beg)
            for seg_beg in range(iter_beg, iter_end, max(seg, 1)):
                seg_end = min(seg_beg + seg, iter_end)
                w = train_fn(
                    w, chunks, mask, jnp.int32(seg_beg), jnp.int32(seg_end)
                )
                if ckpt:
                    self._write_back(w)
                    self.save_checkpoint(checkpoint_path, epoch=seg_end)

        self._write_back(w)
        if verbose:
            print("\n quantization errors:", self.quantization_errors(data2d))
        return self

    def _train_serial(
        self,
        data2d,
        num_epochs,
        iter_beg,
        iter_end,
        verbose,
        checkpoint_path,
        checkpoint_every,
    ):
        """Per-member fast path: each member runs the SAME compiled
        programs single-model training uses (``core.make_train_fn`` /
        ``core.make_epoch_fn`` — fused Pallas BMU, whole-run
        ``fori_loop``), sharing one device-resident copy of the chunked
        data across members. ``lru_cache`` on the program builders means
        members with identical schedules (a seed-only sweep) reuse ONE
        executable. Chunking matches ``XPySom._chunked``'s training
        branch (1024-aligned), so a no-mesh serial sweep is bit-identical
        to training each member individually."""
        from ..parallel.mesh import put_with_sharding

        n = data2d.shape[0]
        # THE shared training-branch sizing (utils.hw.training_chunk) —
        # the 'bit-identical to individual training' guarantee depends on
        # this matching XPySom._chunked exactly (advisor, round 4). The
        # budget is the MEMBER's (identical across members: same map
        # shape, same user n_parallel): this path runs per-member fused
        # programs and never materializes the concatenated matrix the
        # population-level budget is sized against (round-5 review).
        chunk = training_chunk(n, self._members_list[0]._n_parallel)
        n_shards = 1 if self._mesh is None else self._mesh.devices.size
        chunks, mask, _ = chunk_data(data2d, chunk, multiple_of=n_shards)
        if self._mesh is not None:
            sh = data_sharding(self._mesh)
            chunks = put_with_sharding(chunks, sh)
            mask = put_with_sharding(mask, sh)
        else:
            chunks, mask = jnp.asarray(chunks), jnp.asarray(mask)

        def member_w(m):
            w = np.asarray(m._weights, dtype=np.float32)
            if self._mesh is not None:
                return put_with_sharding(w, replicated_sharding(self._mesh))
            return jnp.asarray(w)

        ws = [member_w(m) for m in self._members_list]
        ckpt = bool(checkpoint_every and checkpoint_path)

        if verbose:
            reporter = ProgressReporter(num_epochs * n)
            reporter.start()
            for t in range(iter_beg, iter_end):
                for i, m in enumerate(self._members_list):
                    epoch_fn = core.make_epoch_fn(
                        m._spec, num_epochs, self._mesh
                    )
                    ws[i] = epoch_fn(ws[i], chunks, mask, jnp.int32(t))
                reporter.update(t * n + n - 1)
                if ckpt and (
                    (t + 1 - iter_beg) % checkpoint_every == 0
                    or t + 1 == iter_end
                ):
                    self._write_back_list(ws)
                    self.save_checkpoint(checkpoint_path, epoch=t + 1)
        else:
            seg = checkpoint_every if ckpt else (iter_end - iter_beg)
            for seg_beg in range(iter_beg, iter_end, max(seg, 1)):
                seg_end = min(seg_beg + seg, iter_end)
                for i, m in enumerate(self._members_list):
                    train_fn = core.make_train_fn(
                        m._spec, num_epochs, self._mesh
                    )
                    ws[i] = train_fn(
                        ws[i], chunks, mask,
                        jnp.int32(seg_beg), jnp.int32(seg_end),
                    )
                if ckpt:
                    self._write_back_list(ws)
                    self.save_checkpoint(checkpoint_path, epoch=seg_end)

        self._write_back_list(ws)

    def _train_streaming(
        self,
        data,
        num_epochs,
        iter_beg,
        iter_end,
        verbose,
        checkpoint_path,
        checkpoint_every,
        stats_impl,
    ):
        """Out-of-core sweep: per epoch, fold per-member sufficient
        statistics over streamed superbatches then apply one vmapped
        update — the population analog of
        ``parallel.pipeline.train_streaming``, sharing its fold loop
        (and thus the multi-host superbatch synchronization) via
        ``stats_streaming(stats_fn=...)``. ``stats_impl`` picks the
        per-superbatch program (no default: ``train()``'s 'auto' routing
        owns the measured fused/concat crossover — review, round 5):
        'fused' (lax.map over members with the fused single-model body;
        one pass, one dispatch per superbatch, the measured winner below
        the ~32k-node crossover) or 'concat' (the concatenated-
        codebook GEMM)."""
        from ..parallel.pipeline import (
            ArraySource,
            default_superbatch_rows,
            stats_streaming,
        )

        source = data if hasattr(data, "superbatches") else ArraySource(data)
        d = getattr(source, "dim", self._input_len)
        if d != self._input_len:
            raise ValueError(
                "Received %d features, expected %d." % (d, self._input_len)
            )
        superbatch_rows = default_superbatch_rows(self._input_len)
        specs = self._specs()
        spec0 = specs[0]
        stats_fn = make_population_stats_fn(specs, self._mesh, stats_impl)
        update_fn = make_population_update_fn(specs, num_epochs)
        w = self._stacked_device_weights()

        reporter = (
            ProgressReporter(num_epochs * len(source)) if verbose else None
        )
        if reporter:
            reporter.start()
        n_src = len(source)
        ckpt = bool(checkpoint_every and checkpoint_path)
        # shared training-branch sizing (utils.hw.training_chunk) against
        # the strategy's OWN budget (member-sized for 'fused', which
        # never materializes the concatenated matrix — round-5 review).
        # The 1024-tile alignment matters doubly here: the fused program
        # runs the Pallas BMU inside lax.map over members, so an
        # unaligned chunk would pay the per-scan-step in-graph pad (the
        # measured >100 s compile pathology) P times over
        chunk = training_chunk(
            superbatch_rows, self._stats_n_parallel(stats_impl)
        )
        for t in range(iter_beg, iter_end):
            s, cnt = stats_streaming(
                spec0, w, source, chunk, superbatch_rows, self._mesh,
                stats_fn=stats_fn,
            )
            w = update_fn(w, s, cnt, jnp.int32(t))
            if reporter:
                reporter.update(t * n_src + n_src - 1)
            if ckpt and (
                (t + 1 - iter_beg) % checkpoint_every == 0 or t + 1 == iter_end
            ):
                self._write_back(w)
                self.save_checkpoint(checkpoint_path, epoch=t + 1)
        self._write_back(w)
        if verbose:
            # end-of-sweep QE print, matching the resident path (and the
            # single-model streaming convention): full-source QE would
            # re-stream everything, so evaluate on the first superbatch
            # (bounded, deterministic sample); exhausted one-shot sources
            # just skip the print
            try:
                sample = next(source.superbatches(min(n_src, 65536)))
            except (StopIteration, ValueError):
                sample = None
            if sample is not None and len(sample):
                print("\n quantization errors:", self.quantization_errors(sample))
        return self

    # -- checkpointing ---------------------------------------------------------

    def save_checkpoint(self, path, *, epoch=None):
        """Portable population checkpoint (stacked codebooks + per-member
        RNG + config header); see utils.serialization."""
        from ..utils.serialization import save_population_checkpoint

        save_population_checkpoint(self, path, epoch=epoch)

    @classmethod
    def load_checkpoint(cls, path, *, mesh=None):
        """Rebuild a population from :meth:`save_checkpoint` output.
        ``mesh`` re-attaches a data mesh on the loading host."""
        from ..utils.serialization import load_population_checkpoint

        return load_population_checkpoint(path, mesh=mesh)

    def quantization_errors(self, data) -> np.ndarray:
        """Per-member quantization error, shape ``(P,)`` — every member
        evaluated by one compiled scan over the data. Source-like data
        (DataSource / ``np.memmap``) streams in superbatches like
        single-model ``quantization_error``, folding per-member
        (Σ errors, Σ count) on the host — the out-of-core workflow
        ``train`` accepts composes with model selection too."""
        qe_fn = make_population_qe_fn(
            self._members_list[0]._spec, self._n_members, self._mesh
        )
        src = XPySom._as_source(data)
        if src is not None:
            from ..parallel.mesh import mesh_spans_processes
            from ..parallel.pipeline import default_superbatch_rows

            if mesh_spans_processes(self._mesh):
                raise NotImplementedError(
                    "streaming inference over a multi-host mesh is not "
                    "supported: run it per host with mesh=None or pass "
                    "resident data (identical on every process)"
                )
            w = self._stacked_device_weights()  # one upload per call
            tot = np.zeros((self._n_members,), np.float64)
            n = 0.0
            for block in src.superbatches(
                default_superbatch_rows(self._input_len)
            ):
                block = np.atleast_2d(block)
                self._check_input_len(block)
                # bucketed like single-model streaming QE (som.py): a tail
                # block with a distinct shape must not recompile the QE
                # executable per call pattern
                chunks, mask, _ = self._chunked(block, bucket=True)
                t, c = qe_fn(w, chunks, mask)
                tot += np.asarray(jax.device_get(t), dtype=np.float64)
                n += float(c)
            if n == 0:
                warn(
                    "quantization_errors over an empty data set: returning NaN"
                )
                return np.full((self._n_members,), np.nan, dtype=np.float64)
            return tot / n
        data2d = _as_numpy_2d(data)
        self._check_input_len(data2d)
        chunks, mask, _ = self._chunked(data2d)
        tot, n = qe_fn(self._stacked_device_weights(), chunks, mask)
        n = float(n)
        if n == 0:
            # same empty-input contract as XPySom.quantization_error:
            # warn and return NaN rather than raise (advisor, round 3)
            warn("quantization_errors over an empty data set: returning NaN")
            return np.full((self._n_members,), np.nan, dtype=np.float64)
        return np.asarray(jax.device_get(tot)) / n

    def _check_input_len(self, data2d) -> None:
        """Reference-style feature validation (xpysom.py ValueError) —
        raised eagerly instead of a cryptic trace-time shape error."""
        if data2d.shape[-1] != self._input_len:
            raise ValueError(
                "Received %d features, expected %d."
                % (data2d.shape[-1], self._input_len)
            )

    def best(self, data) -> XPySom:
        """The member with the lowest quantization error on ``data`` — a
        normal ``XPySom`` carrying its population-trained codebook."""
        qes = self.quantization_errors(data)
        if np.isnan(qes).all():
            # empty data warns + NaNs in quantization_errors; argmin over
            # all-NaN would silently "select" member 0 — model selection
            # over nothing is an error, not a warning
            raise ValueError("best() over an empty data set")
        return self._members_list[int(np.argmin(qes))]

    def __repr__(self):
        return (
            f"SomPopulation(n_members={self._n_members}, x={self._x}, "
            f"y={self._y}, input_len={self._input_len})"
        )

    # -- serialization ---------------------------------------------------------

    def __getstate__(self):
        """Pickle support: drop the live mesh handle (members handle their
        own device state in ``XPySom.__getstate__``); re-resolve as
        single-device on load — pass ``mesh=`` again to re-shard."""
        state = self.__dict__.copy()
        state["_mesh"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        # pickles from before the *_explicit flags: auto-sized on the
        # loading host (the XPySom.__setstate__ stance) — checkpoints
        # re-saved from such a population must not pin the resolved
        # n_parallel as user-explicit (save_population_checkpoint)
        self.__dict__.setdefault("_n_parallel_explicit", False)
