"""MiniSom/XPySom-compatible batch SOM model on a jitted JAX core.

API-parity rebuild of the reference ``XPySom`` class
(``xpysom_dask/xpysom.py:72-892``): same constructor surface (xpysom.py:73-82),
same public methods, same quirks where they are observable behavior
(activation map is the *partial* squared distance for 'euclidean'; update
merge rule ``where(den != 0, num/den, W)``; hexagonal ``xx[::-2] -= 0.5``
offset; topographic-error thresholds; ``um/um.max()`` normalization;
``iter_beg``/``iter_end`` segmented training as the checkpoint/resume API).

What changed underneath:

- the NumPy/CuPy ``xp`` backend kwarg becomes a jit-compiled functional core
  (``xpysom_dask_tpu.core``) compiled by XLA for the GPU (or the CPU);
- the inline Dask distribution branches (xpysom.py:545-558) become an
  optional ``jax.sharding.Mesh`` with a ``'data'`` axis: pass ``mesh='auto'``
  (or a mesh / a device count) to shard the sample axis over devices with
  ``psum`` reductions;
- ``use_dask=True`` is accepted for source compatibility and maps to
  ``mesh='auto'`` with a warning; ``xp=`` and ``dask_chunks=`` are accepted
  and ignored.
"""

from __future__ import annotations

import dataclasses
import os
from collections import Counter, defaultdict
from functools import lru_cache
from warnings import warn

import jax
import jax.numpy as jnp
import numpy as np

from .. import core
from ..core import SomSpec, chunk_data, grid_coordinates
from ..ops.decays import DECAY_REGISTRY
from ..ops.distances import DistanceFunction
from ..parallel.mesh import (
    data_sharding,
    fetch_global,
    replicated_sharding,
    resolve_mesh,
)
from ..utils.envflags import env_flag
from ..utils.hw import default_n_parallel, inference_chunk, training_chunk
from ..utils.progress import ProgressReporter

__all__ = ["XPySom"]

_RECT_NEIGS = ("gaussian", "mexican_hat", "bubble", "triangle")
_HEX_NEIGS = ("gaussian", "mexican_hat", "bubble")


@lru_cache(maxsize=1)
def _euclidean_flat_jit():
    """ONE jit wrapper for the distance_from_weights matrix kernel —
    a fresh ``jax.jit(...)`` per call would re-trace every invocation."""
    from ..ops.distances import euclidean_distance

    return jax.jit(euclidean_distance)


def _as_numpy_2d(data) -> np.ndarray:
    """Coerce the input-data ladder of the reference (xpysom.py:487-510) —
    cudf/cupy/dask variants are handled by duck-typing instead of imports:
    anything exposing ``.compute()`` (dask collections) or ``.to_numpy()``
    (pandas/cudf frames) is materialized, then cast to float32."""
    if hasattr(data, "compute"):
        data = data.compute()
    if hasattr(data, "to_numpy"):
        data = data.to_numpy()
    arr = np.asarray(jax.device_get(data) if isinstance(data, jax.Array) else data)
    return np.ascontiguousarray(arr, dtype=np.float32)


class XPySom:
    def __init__(
        self,
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
        xp=None,
        use_dask=False,
        dask_chunks="auto",
        mesh=None,
        bmu_precision=None,
        bmu_tiles=None,
        use_pallas=None,
    ):
        """Initializes a Self Organizing Map.

        Parameter semantics follow the reference constructor
        (xpysom.py:73-253). Additions:

        mesh : None | 'auto' | int | jax.sharding.Mesh (default=None)
            Data-parallel device mesh. 'auto' uses every local device;
            an int uses that many; a Mesh must carry a 'data' axis.

        bmu_precision : str (default: 'packed')
            Numerical mode of the fused BMU kernel on the GPU:
            'packed' (3-term bf16-split products, exact argmin against
            float64 outside near-ties), 'split2' (2-term), 'bf16'
            (single pass, flips near-tied winners), or 'highest' (the
            f32 XLA reference, no kernel). Paths without the kernel
            (the CPU, non-euclidean/cosine activations) always compute
            exact f32 distances. Part of the compiled spec — switching
            modes compiles a second executable.

        bmu_tiles : (BN, BJ) or (BN, BJ, num_warps, num_stages)
            Kernel block override (BN, BJ powers of two >= 16; default:
            the per-width table in ``ops.pallas.bmu``).

        use_pallas : bool (default True)
            False forces the plain-XLA BMU formulation (the reference's
            ``_no_opt`` testing pattern, tests.py:24-31).

        Each of the three defaults can be overridden by the env switches
        ``XPYSOM_BMU_PRECISION`` / ``XPYSOM_BMU_TILES`` /
        ``XPYSOM_NO_PALLAS``, read ONCE here at construction; explicit
        constructor arguments always win.

        Accepted for source compatibility and ignored: ``xp`` (the backend
        is always XLA), ``dask_chunks``. ``use_dask=True`` maps to
        ``mesh='auto'`` with a warning.
        """
        if sigma >= x or sigma >= y:
            warn("Warning: sigma is too high for the dimension of the map.")

        self._random_generator = np.random.RandomState(random_seed)

        if xp is not None:
            warn("xp= is ignored: computation always runs on the XLA backend.")
        if use_dask:
            warn("use_dask is deprecated: mapping to mesh='auto' (shard_map DP).")
            if mesh is None:
                mesh = "auto"
        self.dask_chunks = dask_chunks  # accepted, unused

        self._learning_rate = learning_rate
        self._learning_rateN = learning_rateN

        if sigma == 0:
            self._sigma = min(x, y) / 2
        else:
            self._sigma = sigma
        self._sigmaN = sigmaN
        self._std_coeff = std_coeff
        self._input_len = input_len
        self._x = x
        self._y = y

        # Random init: uniform in [-1, 1), each code vector L2-normalized
        # (reference xpysom.py:188-190). float64 until train() casts to f32.
        self._weights = self._random_generator.rand(x, y, input_len) * 2 - 1
        self._weights /= np.linalg.norm(self._weights, axis=-1, keepdims=True)

        if topology not in ["hexagonal", "rectangular"]:
            msg = "%s not supported only hexagonal and rectangular available"
            raise ValueError(msg % topology)
        self.topology = topology

        # Euclidean coordinate meshes, shape (y, x), hex offset applied
        # (reference xpysom.py:201-206).
        self._xx, self._yy = grid_coordinates(x, y, topology)
        self._neigx = np.arange(x)
        self._neigy = np.arange(y)

        if topology == "hexagonal" and neighborhood_function in ["triangle"]:
            # Reference quirk preserved EXACTLY (xpysom.py:206-208 then
            # :227-230): the reference warns here, then its hexagonal
            # neig_functions dict (xpysom.py:271-280) has no 'triangle'
            # entry, so the availability check below raises anyway. The
            # warn-then-raise sequence is the reference's own behavior,
            # not a bug in this rebuild (round-5 review: verified against
            # the reference before touching it).
            warn(
                "triangle neighborhood function does not "
                + "take in account hexagonal topology"
            )

        if decay_function not in DECAY_REGISTRY:
            msg = "%s not supported. Functions available: %s"
            raise ValueError(msg % (decay_function, ", ".join(DECAY_REGISTRY.keys())))
        self._decay_function_name = decay_function

        self.compact_support = compact_support

        available = _RECT_NEIGS if topology == "rectangular" else _HEX_NEIGS
        if neighborhood_function not in available:
            msg = "%s not supported. Functions available: %s"
            raise ValueError(msg % (neighborhood_function, ", ".join(available)))
        self.neighborhood_func_name = neighborhood_function

        # Validates the distance name (raises ValueError like
        # distances.py:172-175).
        self._activation_distance_name = activation_distance
        self._activation_distance_kwargs = dict(activation_distance_kwargs)
        dist_obj = DistanceFunction(activation_distance, self._activation_distance_kwargs)

        # First-class kernel config. VALIDATION and RESOLUTION — mode
        # list, tile contract, env reads, norm_p safety rules, coercion —
        # all live at the one documented boundary, SomSpec.__post_init__:
        # the probe spec below raises the boundary's ValueErrors from the
        # constructor (the reference's constructor-kwargs-with-ValueErrors
        # config bar, xpysom.py:73-161) without a second hand-maintained
        # copy of the rules here (round-5 review: the two copies could
        # drift). The resolved values are read back; the _spec property
        # then always passes these CONCRETE values, so a later env change
        # can never reach an already-built model.
        self._use_pallas_explicit = use_pallas is not None
        self._bmu_precision_explicit = bmu_precision is not None
        self._bmu_tiles_explicit = bmu_tiles is not None
        cfg = SomSpec(
            1, 1, 1, 1.0, 1.0, 0.5, 0.01,
            distance=activation_distance,
            bmu_precision=(
                bmu_precision if self._bmu_precision_explicit else core.FROM_ENV
            ),
            bmu_tiles=bmu_tiles if self._bmu_tiles_explicit else core.FROM_ENV,
            use_pallas=use_pallas if self._use_pallas_explicit else core.FROM_ENV,
        )
        self._bmu_precision = cfg.bmu_precision
        self._bmu_tiles = cfg.bmu_tiles  # block override or None = table
        self._use_pallas = cfg.use_pallas
        if self._bmu_precision == "split2" and input_len < 32:
            # split2's self-consistent ‖w_h‖² makes nodes whose bf16
            # shadows coincide tie EXACTLY, and the first-index tie-break
            # then starves the later node for the rest of training (map
            # collapse on low-D clustered data). The tie basin shrinks as
            # ~2⁻⁸ᴰ, so it is a low-D hazard only.
            warn(
                f"bmu_precision='split2' with input_len={input_len} < 32: "
                "coincident bf16 codebook shadows can starve nodes during "
                "training (map collapse) — prefer 'packed' here."
            )

        # The fused-kernel chunk default is only safe on paths that never
        # materialize the (chunk, XY) distance matrix — ask the kernel
        # dispatch itself (the same gates training traces: backend,
        # activation, feature width, config), so e.g. use_pallas=False
        # configs keep the budgeted default.
        self._n_parallel_explicit = n_parallel != 0
        if n_parallel == 0:
            fused = (
                core._pallas_bmu_kind(
                    dist_obj, input_len, self._use_pallas, self._bmu_precision
                )
                is not None
            )
            n_parallel = default_n_parallel(x * y, fused=fused)
        self._n_parallel = int(n_parallel)

        self._mesh_arg = mesh
        self._mesh = resolve_mesh(mesh)

    # -- static spec / compiled-fn plumbing --------------------------------

    @property
    def _spec(self) -> SomSpec:
        return SomSpec(
            x=self._x,
            y=self._y,
            input_len=self._input_len,
            sigma=float(self._sigma),
            sigmaN=float(self._sigmaN),
            learning_rate=float(self._learning_rate),
            learning_rateN=float(self._learning_rateN),
            decay=self._decay_function_name,
            neighborhood=self.neighborhood_func_name,
            std_coeff=float(self._std_coeff),
            topology=self.topology,
            distance=self._activation_distance_name,
            distance_kwargs=tuple(sorted(self._activation_distance_kwargs.items())),
            compact_support=bool(self.compact_support),
            bmu_precision=self._bmu_precision,
            bmu_tiles=self._bmu_tiles,
            use_pallas=self._use_pallas,
        )

    def _is_grid_mesh(self) -> bool:
        from ..parallel.grid_sharded import is_grid_mesh

        return is_grid_mesh(self._mesh)

    def _n_shards(self) -> int:
        if self._mesh is None:
            return 1
        if self._is_grid_mesh():
            return int(self._mesh.shape["data"])
        return self._mesh.devices.size

    @property
    def _matrix_chunk(self) -> int:
        """Chunk size for paths that MATERIALIZE the (chunk, XY) distance
        matrix (topographic top-2, distance_from_weights, the XLA BMU
        fallback): the fused-kernel default chunk would transiently
        allocate chunk·XY·4 bytes — 17 GB at XY=512² — so auto-sized SOMs
        fall back to the element-budgeted default here. An explicit user
        ``n_parallel`` is honored everywhere (it IS the reference's memory
        bound, xpysom.py:131-137)."""
        if self._n_parallel_explicit:
            return self._n_parallel
        return min(
            self._n_parallel, default_n_parallel(self._x * self._y, fused=False)
        )

    def _chunked(self, data2d: np.ndarray, chunk: int = None, bucket: bool = False):
        """Pad + chunk host data and place it on device(s).

        Chunk sizes above one row block are whole multiples of the fused
        kernel's row block (``utils.hw.ROW_BLOCK``), so no chunk pads per
        scan step. Alignment rounds DOWN so a user-specified
        ``n_parallel`` (a memory budget, reference xpysom.py:131-137) is
        never exceeded.

        ``bucket=True`` (the INFERENCE paths — winner/predict/QE/TE) snaps
        the padded shape onto a small ladder so repeated calls with
        varying batch sizes reuse executables instead of retracing per
        distinct length (the reference paid no compile step, so this cost
        class must stay bounded): see ``utils.hw.inference_chunk``.
        Training never buckets (one dataset → one trace; padding there
        would cost every epoch)."""
        n = data2d.shape[0]
        min_chunks = 1
        if bucket:
            # budget cap only (do NOT shrink to this call's n — that is
            # exactly the per-length retrace this path exists to avoid)
            chunk, min_chunks = inference_chunk(n, chunk or self._n_parallel)
        else:
            chunk = training_chunk(n, chunk or self._n_parallel)
        chunks, mask, _ = chunk_data(
            data2d, chunk, multiple_of=self._n_shards(), min_chunks=min_chunks
        )
        if self._mesh is not None:
            # resident data is identical on every process (the user passed
            # the same array everywhere), so the multi-process-safe put
            # materializes each host's own global slices
            from ..parallel.mesh import put_with_sharding

            sh = data_sharding(self._mesh)
            return (
                put_with_sharding(chunks, sh),
                put_with_sharding(mask, sh),
                n,
            )
        return jnp.asarray(chunks), jnp.asarray(mask), n

    def _device_weights(self):
        from ..parallel.mesh import put_with_sharding

        w = np.asarray(self._weights, dtype=np.float32)
        if self._mesh is None:
            return jnp.asarray(w)
        if self._is_grid_mesh():
            from ..parallel.grid_sharded import MODEL_AXIS, codebook_sharding

            n_model = int(self._mesh.shape[MODEL_AXIS])
            if self._x % n_model:
                raise ValueError(
                    f"grid X={self._x} must divide evenly over {n_model} "
                    f"model shards (codebook shards along X)"
                )
            return put_with_sharding(w, codebook_sharding(self._mesh))
        return put_with_sharding(w, replicated_sharding(self._mesh))

    # -- introspection ------------------------------------------------------

    def get_neig_functions(self):
        """Dictionary of (name, prepared neighborhood callable ``f(c, σ)``)
        for this map's topology — reference xpysom.py:255-283. Callables
        are the batched parity-form kernels from ``ops.neighborhoods``
        (jax arrays out); hexagonal maps omit 'triangle' like the
        reference."""
        from ..ops import neighborhoods as nb

        neigx = jnp.asarray(self._neigx, jnp.float32)
        neigy = jnp.asarray(self._neigy, jnp.float32)
        if self.topology == "rectangular":
            return {
                "gaussian": nb.prepare_neig_func(
                    nb.gaussian_rect, neigx, neigy, self._std_coeff,
                    self.compact_support,
                ),
                "mexican_hat": nb.prepare_neig_func(
                    nb.mexican_hat_rect, neigx, neigy, self._std_coeff,
                    self.compact_support,
                ),
                "bubble": nb.prepare_neig_func(nb.bubble, neigx, neigy),
                "triangle": nb.prepare_neig_func(
                    nb.triangle, neigx, neigy, self.compact_support
                ),
            }
        if self.topology == "hexagonal":
            xx = jnp.asarray(self._xx, jnp.float32)
            yy = jnp.asarray(self._yy, jnp.float32)
            return {
                "gaussian": nb.prepare_neig_func(
                    nb.gaussian_generic, xx, yy, self._std_coeff,
                    self.compact_support,
                ),
                "mexican_hat": nb.prepare_neig_func(
                    nb.mexican_hat_generic, xx, yy, self._std_coeff,
                    self.compact_support,
                ),
                "bubble": nb.prepare_neig_func(nb.bubble, neigx, neigy),
            }
        return {}

    def get_weights(self):
        """Returns the weights of the neural network."""
        return self._weights

    def get_euclidean_coordinates(self):
        """Euclidean-plane positions of the neurons as two meshgrids
        (reference xpysom.py:291-305)."""
        return self._xx.T, self._yy.T

    def convert_map_to_euclidean(self, xy):
        """Map coordinates → euclidean coordinates for the chosen topology
        (reference xpysom.py:308-320)."""
        return self._xx.T[xy], self._yy.T[xy]

    # -- streaming (out-of-core) inference helpers -----------------------------

    @staticmethod
    def _as_source(data):
        """DataSource for source-like inputs (anything with
        ``superbatches`` or an ``np.memmap``), else None — the same
        duck-typing ``train`` uses for its out-of-core path."""
        if hasattr(data, "superbatches"):
            return data
        if isinstance(data, np.memmap):
            from ..parallel.pipeline import ArraySource

            return ArraySource(data)
        return None

    def _guard_multihost_streaming_inference(self):
        """Streaming INFERENCE over a mesh that spans processes is gated:
        per-host sources yield per-host-distinct blocks whose counts and
        shapes are not synchronized on the inference paths (the training
        loop is — parallel.pipeline._synced_superbatches), so collectives
        would desync and per-row outputs would interleave wrongly. Run
        inference per host with mesh=None (it is embarrassingly
        parallel), or pass resident (process-identical) data."""
        from ..parallel.mesh import mesh_spans_processes

        if mesh_spans_processes(self._mesh):
            raise NotImplementedError(
                "streaming inference over a multi-host mesh is not "
                "supported: run it per host with mesh=None (per-row "
                "inference is embarrassingly parallel) or pass resident "
                "data (identical on every process)"
            )

    def _superbatch_rows(self) -> int:
        """~256 MB device-resident blocks — the pipeline's shared rule."""
        from ..parallel.pipeline import default_superbatch_rows

        return default_superbatch_rows(self._input_len)

    # -- activation / winner -------------------------------------------------

    def activate(self, x):
        """Activation map for x: element (n, j) is the response of flat
        neuron j to sample n. For the default 'euclidean' this is the
        *partial* squared distance (argmin-equivalent; reference
        xpysom.py:323-354, distances.py:163)."""
        x2d = np.atleast_2d(_as_numpy_2d(x)).astype(np.float32, copy=False)
        self._check_input_len(x2d)
        dist = self._spec.distance_fn()
        w_host = np.asarray(self._weights, dtype=np.float32).reshape(
            -1, self._input_len
        )
        w_flat = jnp.asarray(w_host)
        # the (N, XY) result materializes on device per chunk — budget it
        # like the sibling matrix-materializing path
        # (distance_from_weights); eager like before (a fresh
        # DistanceFunction per call would defeat jit's identity cache)
        return self._chunked_matrix(x2d, w_flat, dist.flat)

    def _chunked_matrix(self, data_np, w_flat, fn) -> np.ndarray:
        """Shared chunked (N, XY) matrix materialization (activate /
        distance_from_weights): dispatches run ahead of the fetches with
        a small in-flight window so device compute, H2D/D2H copies and
        host assembly overlap instead of ping-ponging; device memory in
        flight stays bounded by window · chunk · XY floats."""
        n, xy = data_np.shape[0], w_flat.shape[0]
        out = np.empty((n, xy), dtype=np.float32)
        step = self._matrix_chunk
        spans = [(s, min(s + step, n)) for s in range(0, n, step)]
        # bound in-flight device results to ~256 MB regardless of shape
        window = max(1, min(4, (1 << 26) // max(step * xy, 1)))
        pending = []
        for s, e in spans:
            pending.append((s, e, fn(jnp.asarray(data_np[s:e]), w_flat)))
            if len(pending) >= window:
                ps, pe, arr = pending.pop(0)
                out[ps:pe] = np.asarray(arr)
        for ps, pe, arr in pending:
            out[ps:pe] = np.asarray(arr)
        return out

    def _winner_flat(
        self, data2d: np.ndarray, spec: SomSpec = None, w=None
    ) -> np.ndarray:
        """``w`` lets streaming loops hoist the codebook upload out of
        their per-superbatch iteration (re-putting a 512x512x64 codebook
        per ~256 MB block is pure wasted transfer)."""
        spec = spec or self._spec
        self._check_input_len(data2d)
        if data2d.shape[0] == 0:
            # mirrors streaming predict's exhausted-source result; also
            # serves winner([]) -> [] and quantization(empty) -> empty
            return np.empty(0, dtype=np.int64)
        chunks, _, n = self._chunked(data2d, bucket=True)
        if self._is_grid_mesh():
            from ..parallel.grid_sharded import make_bmu_fn_2d

            bmu_fn = make_bmu_fn_2d(spec, self._mesh)
        else:
            bmu_fn = core.make_bmu_fn(spec, self._mesh)
        bmu = bmu_fn(self._device_weights() if w is None else w, chunks)
        if jax.process_count() > 1 and self._mesh is not None:
            # the per-row output is sharded over 'data' across PROCESSES
            # (out_specs=P('data')) — np.asarray on a non-addressable
            # array raises; gather the full result onto every host (this
            # is the supported multi-host inference path, see
            # _guard_multihost_streaming_inference)
            from jax.experimental import multihost_utils

            bmu = multihost_utils.process_allgather(bmu, tiled=True)
        return np.asarray(bmu).reshape(-1)[:n]

    def winner(self, x):
        """Coordinates of the winning neurons for samples x
        (reference xpysom.py:370-408)."""
        arr = _as_numpy_2d(x)
        single = arr.ndim <= 1
        data2d = np.atleast_2d(arr)
        flat = self._winner_flat(data2d)
        wx, wy = flat // self._y, flat % self._y
        if single:
            return (int(wx[0]), int(wy[0]))
        return [(int(a), int(b)) for a, b in zip(wx, wy)]

    def predict(self, data):
        """Flat (raveled) winner index per sample (reference
        xpysom.py:608-617). Source-like data (DataSource / np.memmap)
        streams through the device in superbatches — out-of-core serving,
        same duck-typing as ``train``."""
        src = self._as_source(data)
        if src is not None:
            self._guard_multihost_streaming_inference()
            out = []
            w = self._device_weights()  # hoisted: one upload per call
            for block in src.superbatches(self._superbatch_rows()):
                block = np.atleast_2d(block)
                self._check_input_len(block)
                out.append(self._winner_flat(block, w=w))
            if not out:
                return np.empty(0, dtype=np.int64)
            return np.concatenate(out).astype(np.int64)
        data2d = np.atleast_2d(_as_numpy_2d(data))
        return self._winner_flat(data2d).astype(np.int64)

    # -- training ------------------------------------------------------------

    def train(
        self,
        data,
        num_epochs,
        iter_beg=0,
        iter_end=None,
        verbose=False,
        checkpoint_path=None,
        checkpoint_every=0,
    ):
        """Trains the SOM (reference xpysom.py:458-594).

        ``iter_beg``/``iter_end`` run epochs ``[iter_beg, iter_end)`` of a
        ``num_epochs``-epoch schedule — decays are computed against the
        total, so segmented training (checkpoint/resume) composes exactly
        like the reference's.

        ``checkpoint_path`` + ``checkpoint_every=k`` write a portable .npz
        checkpoint every k epochs (and at the end) — the fault-tolerance
        mechanism for long runs (the reference has none beyond pickle,
        SURVEY.md §5): after a failure, ``XPySom.load_checkpoint(path)``
        and ``train(data, num_epochs, iter_beg=ckpt._checkpoint_epoch)``
        resume exactly.

        Determinism: each setting of ``verbose`` is bit-reproducible,
        but ``verbose=True`` (per-epoch dispatch) and ``verbose=False``
        (whole-run on-device loop) compile *different programs* of the
        same f32 math and can diverge on near-tie codebooks — compare
        across program variants by quantization error, not bitwise
        weights (docs/MIGRATION.md, behavioral delta 7)."""
        if checkpoint_every < 0:
            raise ValueError(
                f"checkpoint_every={checkpoint_every} must be >= 0"
            )
        if iter_end is None:
            iter_end = num_epochs

        # Out-of-core path: DataSource-like objects and np.memmap stream
        # superbatches through the device instead of residing on it
        # (parallel.pipeline; replaces the reference's Dask-chunk shipping).
        if hasattr(data, "superbatches") or isinstance(data, np.memmap):
            from ..parallel.pipeline import ArraySource, train_streaming

            source = data if hasattr(data, "superbatches") else ArraySource(data)
            reporter = (
                ProgressReporter(num_epochs * len(source)) if verbose else None
            )
            n_src = len(source)

            def stream_progress(t):
                reporter.update(t * n_src + n_src - 1)

            seg = checkpoint_every if (checkpoint_every and checkpoint_path) else (
                iter_end - iter_beg
            )
            w_host = np.asarray(self._weights, dtype=np.float32)
            for seg_beg in range(iter_beg, iter_end, max(seg, 1)):
                seg_end = min(seg_beg + seg, iter_end)
                w_host = train_streaming(
                    self._spec,
                    w_host,
                    source,
                    num_epochs,
                    iter_beg=seg_beg,
                    iter_end=seg_end,
                    chunk=self._n_parallel,
                    mesh=self._mesh,
                    progress=stream_progress if reporter else None,
                )
                self._weights = w_host
                if checkpoint_every and checkpoint_path:
                    self.save_checkpoint(checkpoint_path, epoch=seg_end)
            if verbose:
                # End-of-training QE print, matching the resident path and
                # the reference (xpysom.py:591-592). Full-source QE would
                # re-stream everything, so evaluate on the first
                # superbatch (bounded, deterministic sample). Empty or
                # exhausted one-shot sources just skip the print — the
                # training itself already completed.
                try:
                    sample = next(source.superbatches(min(n_src, 65536)))
                except (StopIteration, ValueError):
                    sample = None
                if sample is not None and len(sample):
                    print(
                        "\n quantization error:",
                        self.quantization_error(sample),
                    )
            return self

        data2d = _as_numpy_2d(data)
        chunks, mask, n = self._chunked(data2d)
        w = self._device_weights()

        grid = self._is_grid_mesh()
        if grid:
            from ..parallel import grid_sharded as _gs
        if verbose:
            # per-epoch dispatch so progress can be reported
            epoch_fn = (
                _gs.make_epoch_fn_2d(self._spec, num_epochs, self._mesh)
                if grid
                else core.make_epoch_fn(self._spec, num_epochs, self._mesh)
            )
            reporter = ProgressReporter(num_epochs * n)
            reporter.start()
            for t in range(iter_beg, iter_end):
                w = epoch_fn(w, chunks, mask, jnp.int32(t))
                reporter.update(t * n + n - 1)
                if checkpoint_every and checkpoint_path and (
                    (t + 1 - iter_beg) % checkpoint_every == 0 or t + 1 == iter_end
                ):
                    self._weights = fetch_global(w)
                    self.save_checkpoint(checkpoint_path, epoch=t + 1)
        else:
            # whole run in one executable per checkpoint segment (data and
            # codebook stay on device across segments)
            train_fn = (
                _gs.make_train_fn_2d(self._spec, num_epochs, self._mesh)
                if grid
                else core.make_train_fn(self._spec, num_epochs, self._mesh)
            )
            seg = checkpoint_every if (checkpoint_every and checkpoint_path) else (
                iter_end - iter_beg
            )
            for seg_beg in range(iter_beg, iter_end, max(seg, 1)):
                seg_end = min(seg_beg + seg, iter_end)
                w = train_fn(
                    w, chunks, mask, jnp.int32(seg_beg), jnp.int32(seg_end)
                )
                if checkpoint_every and checkpoint_path:
                    self._weights = fetch_global(w)
                    self.save_checkpoint(checkpoint_path, epoch=seg_end)

        self._weights = fetch_global(w)

        if verbose:
            print("\n quantization error:", self.quantization_error(data2d))

        return self

    def train_batch(self, data, num_iteration, verbose=False):
        """Compatibility with MiniSom, alias for train."""
        return self.train(data, num_iteration, verbose=verbose)

    def train_random(self, data, num_iteration, verbose=False):
        """Compatibility with MiniSom, alias for train."""
        print(
            "WARNING: due to batch SOM algorithm, random order is not "
            "supported. Falling back to train_batch."
        )
        return self.train(data, num_iteration, verbose=verbose)

    # -- quantization / metrics ----------------------------------------------

    def _check_input_len(self, data):
        # empty batches carry their width in the shape (data[0] would
        # IndexError); width-validate them too so the empty-input
        # contracts below still reject wrong-width empties
        if getattr(data, "ndim", 0) >= 2:
            data_len = data.shape[-1]
        else:
            data_len = len(data[0])
        if self._input_len != data_len:
            msg = "Received %d features, expected %d." % (data_len, self._input_len)
            raise ValueError(msg)

    def quantization(self, data):
        """Code book vector of the winning neuron for each sample
        (reference xpysom.py:620-645). BMU by euclidean distance regardless
        of the activation distance, matching the reference."""

        data2d = np.atleast_2d(_as_numpy_2d(data))
        self._check_input_len(data2d)
        spec = self._spec
        eucl_spec = (
            spec
            if spec.distance == "euclidean"
            else dataclasses.replace(spec, distance="euclidean", distance_kwargs=())
        )
        bmu = self._winner_flat(data2d, spec=eucl_spec)
        return self._weights.reshape(-1, self._input_len)[bmu]

    def distance_from_weights(self, data, weights=None):
        """Full (N, X·Y) euclidean distance matrix against ``weights``
        (default: this SOM's codebook), computed in budgeted chunks like
        the reference (xpysom.py:647-671).

        The result lives on the host (it can dwarf HBM at large N):
        chunks are uploaded one at a time and dispatches run ahead of the
        fetches with a small in-flight window, so device compute, H2D/D2H
        copies and host assembly overlap instead of ping-ponging. Device
        memory in flight stays bounded by window · chunk · XY floats."""
        data2d = np.atleast_2d(_as_numpy_2d(data))
        w_host = np.asarray(
            self._weights if weights is None else weights, dtype=np.float32
        ).reshape(-1, self._input_len)
        w_flat = jnp.asarray(w_host)
        data_np = data2d.astype(np.float32, copy=False)
        return self._chunked_matrix(data_np, w_flat, _euclidean_flat_jit())

    def _qe_fn(self):
        if self._is_grid_mesh():
            from ..parallel.grid_sharded import make_quantization_stats_fn_2d

            return make_quantization_stats_fn_2d(self._spec, self._mesh)
        return core.make_quantization_stats_fn(self._spec, self._mesh)

    def quantization_error(self, data):
        """Mean distance between samples and their BMU code vectors
        (reference xpysom.py:673-707). Source-like data streams in
        superbatches, folding (Σ errors, Σ count) on the host — the
        out-of-core counterpart of the resident path."""
        src = self._as_source(data)
        if src is not None:
            self._guard_multihost_streaming_inference()
            fn = self._qe_fn()
            w = self._device_weights()
            tot = n = 0.0
            for block in src.superbatches(self._superbatch_rows()):
                block = np.atleast_2d(block)
                self._check_input_len(block)
                chunks, mask, _ = self._chunked(block, bucket=True)
                t, c = fn(w, chunks, mask)
                tot += float(t)
                n += float(c)
            if n == 0:
                # empty/exhausted one-shot source: mirror predict's
                # empty-array handling — a mean over nothing is NaN
                warn("quantization_error: source yielded no rows.")
                return float("nan")
            return tot / n
        data2d = np.atleast_2d(_as_numpy_2d(data))
        self._check_input_len(data2d)
        if data2d.shape[0] == 0:
            # the empty-input contract the streaming branch (above) and
            # SomPopulation.quantization_errors document: warn + NaN, a
            # mean over nothing — not an exception
            warn("quantization_error: received no rows.")
            return float("nan")
        chunks, mask, _ = self._chunked(data2d, bucket=True)
        tot, n = self._qe_fn()(self._device_weights(), chunks, mask)
        return float(tot) / float(n)

    def topographic_error(self, data):
        """Fraction of samples whose two best-matching units are not
        adjacent (reference xpysom.py:709-746). Source-like data streams
        in superbatches like ``predict``/``quantization_error``."""
        if self._x * self._y == 1:  # once, not per superbatch
            warn("The topographic error is not defined for a 1-by-1 map.")
            return np.nan
        src = self._as_source(data)
        if src is not None:
            self._guard_multihost_streaming_inference()
            # hoist the codebook upload out of the block loop like the
            # sibling streaming metrics (predict/QE/activation_response):
            # re-putting a large codebook per block is pure wasted transfer
            w = self._device_weights()
            errs = n = 0.0
            for block in src.superbatches(self._superbatch_rows()):
                e, c = self._te_counts(np.atleast_2d(block), w=w)
                errs += e
                n += c
            if n == 0:
                warn("topographic_error: source yielded no rows.")
                return float("nan")
            return errs / n
        data2d = np.atleast_2d(_as_numpy_2d(data))
        self._check_input_len(data2d)
        if data2d.shape[0] == 0:
            # same empty-input contract as quantization_error
            warn("topographic_error: received no rows.")
            return float("nan")
        e, c = self._te_counts(data2d)
        return e / c

    def _te_counts(self, data2d, w=None):
        """(Σ errors, Σ count) for one resident block — the reusable body
        of topographic_error. ``w`` (optional) is a pre-placed device
        codebook, hoisted by the streaming loop so it uploads once per
        call rather than once per superbatch."""
        self._check_input_len(data2d)
        # reference guards on prod(weights.shape) (xpysom.py:721) and then
        # degrades to a NaN-with-warnings mean over an empty diff for 1x1
        # maps with D > 1; we guard on the actual neuron count so every 1x1
        # map returns NaN instead of crashing in top-2 selection
        if self._x * self._y == 1:
            warn("The topographic error is not defined for a 1-by-1 map.")
            return np.nan, 1.0
        # fallback top-2 selection materializes (chunk, XY/shards)
        # distances — budget the chunk independently of the fused
        # training default; the fused top-2 kernel (core.te_uses_fused)
        # never writes the matrix and takes training-sized chunks
        te_chunk = (
            None
            if (not self._is_grid_mesh() and core.te_uses_fused(self._spec))
            else self._matrix_chunk
        )
        chunks, mask, _ = self._chunked(data2d, chunk=te_chunk, bucket=True)
        if self._is_grid_mesh():
            from ..parallel.grid_sharded import (
                MODEL_AXIS,
                make_topographic_stats_fn_2d,
            )

            n_model = int(self._mesh.shape[MODEL_AXIS])
            if (self._x * self._y) // n_model >= 2:
                fn = make_topographic_stats_fn_2d(self._spec, self._mesh)
                errs, n = fn(
                    self._device_weights() if w is None else w, chunks, mask
                )
                return float(errs), float(n)
            # tiny maps leave <2 codebook rows per model shard — the
            # sharded top-2 merge is undefined there; compute replicated
            # on one device from the host codebook instead of crashing
            h_chunks, h_mask, _ = core.chunk_data(
                data2d.astype(np.float32, copy=False), self._matrix_chunk
            )
            fn = core.make_topographic_stats_fn(self._spec, mesh=None)
            errs, n = fn(
                jnp.asarray(np.asarray(self._weights, dtype=np.float32)),
                jnp.asarray(h_chunks),
                jnp.asarray(h_mask),
            )
            return float(errs), float(n)
        fn = core.make_topographic_stats_fn(self._spec, self._mesh)
        errs, n = fn(self._device_weights() if w is None else w, chunks, mask)
        return float(errs), float(n)

    # -- weight initialization ------------------------------------------------

    def random_weights_init(self, data):
        """Init weights by picking random data samples (semantics of
        reference xpysom.py:749-759). One vectorized sized draw: a legacy
        ``RandomState.randint(n, size=k)`` emits the identical stream as k
        scalar ``randint(n)`` calls, and a C-order ``reshape(x, y)`` visits
        cells in the reference's nditer multi-index order, so the resulting
        codebook is bit-identical (pinned by test_som.py)."""
        self._check_input_len(data)
        data = np.asarray(data)
        idx = self._random_generator.randint(
            len(data), size=self._x * self._y
        )
        self._weights[...] = data[idx].reshape(
            self._x, self._y, self._input_len
        )

    def pca_weights_init(self, data):
        """Init weights spanning the first two principal components
        (semantics of reference xpysom.py:762-785, incl. its *row*-indexing
        of the eigenvector matrix, which the parity tests pin down). The
        grid fill is a single broadcasted outer sum over the two component
        coefficients instead of a per-cell double loop."""
        if self._input_len == 1:
            msg = "The data needs at least 2 features for pca initialization"
            raise ValueError(msg)
        self._check_input_len(data)
        if len(self._neigx) == 1 or len(self._neigy) == 1:
            msg = (
                "PCA initialization inappropriate:"
                + "One of the dimensions of the map is 1."
            )
            warn(msg)
        pc_length, pc = np.linalg.eig(np.cov(np.transpose(data)))
        pc_order = np.argsort(-pc_length)
        c1 = np.linspace(-1, 1, len(self._neigx))[:, None, None]
        c2 = np.linspace(-1, 1, len(self._neigy))[None, :, None]
        self._weights[...] = c1 * pc[pc_order[0]] + c2 * pc[pc_order[1]]

    # -- analysis -------------------------------------------------------------

    def distance_map(self):
        """U-matrix: normalized sum of distances between each neuron and its
        neighbors (reference xpysom.py:788-817), vectorized over the grid:
        one shifted-difference norm per neighbor offset instead of a Python
        loop over cells."""
        w = np.asarray(self._weights, dtype=np.float64)
        x_dim, y_dim = w.shape[0], w.shape[1]

        ii = [[0, -1, -1, -1, 0, 1, 1, 1]] * 2
        jj = [[-1, -1, 0, 1, 1, 1, 0, -1]] * 2
        if self.topology == "hexagonal":
            ii = [[1, 1, 1, 0, -1, 0], [0, 1, 0, -1, -1, -1]]
            jj = [[1, 0, -1, -1, 0, 1], [1, 0, -1, -1, 0, 1]]

        def offset_norms(i, j):
            out = np.zeros((x_dim, y_dim))
            x0, x1 = max(0, -i), x_dim - max(0, i)
            y0, y1 = max(0, -j), y_dim - max(0, j)
            if x0 < x1 and y0 < y1:
                out[x0:x1, y0:y1] = np.linalg.norm(
                    w[x0:x1, y0:y1] - w[x0 + i : x1 + i, y0 + j : y1 + j], axis=-1
                )
            return out

        sums = [
            np.sum([offset_norms(i, j) for i, j in zip(ii[e], jj[e])], axis=0)
            for e in (0, 1)
        ]
        if self.topology == "hexagonal":
            # e = (y % 2 == 0) selects the offset set per column parity
            # (reference xpysom.py:809-810).
            even_col = (np.arange(y_dim) % 2 == 0)[None, :]
            um = np.where(even_col, sums[1], sums[0])
        else:
            um = sums[0]
        return um / um.max()

    def activation_response(self, data):
        """Counts how many times each neuron wins (reference
        xpysom.py:819-829). Source-like data streams in superbatches —
        the per-cell counts fold, so out-of-core datasets work like in
        ``predict``/``quantization_error``."""
        a = np.zeros((self._weights.shape[0], self._weights.shape[1]))

        def fold(block, w=None):
            self._check_input_len(block)
            flat = self._winner_flat(block, w=w)
            np.add.at(a, (flat // self._y, flat % self._y), 1)

        src = self._as_source(data)
        if src is not None:
            self._guard_multihost_streaming_inference()
            w = self._device_weights()  # hoisted: one upload per call
            for block in src.superbatches(self._superbatch_rows()):
                fold(np.atleast_2d(block), w=w)
            return a
        fold(np.atleast_2d(_as_numpy_2d(data)))
        return a

    def win_map(self, data):
        """Dict (i, j) → list of samples mapped there (reference
        xpysom.py:831-840)."""
        self._check_input_len(data)
        winmap = defaultdict(list)
        winners = self.winner(data)
        for x, win in zip(data, winners):
            winmap[win].append(x)
        return winmap

    def labels_map(self, data, labels):
        """Dict (i, j) → Counter of labels mapped there (reference
        xpysom.py:842-865)."""
        self._check_input_len(data)
        if not len(data) == len(labels):
            raise ValueError("data and labels must have the same length.")
        winmap = defaultdict(list)
        winners = self.winner(data)
        for win, l in zip(winners, labels):
            winmap[win].append(l)
        for position in winmap:
            winmap[position] = Counter(winmap[position])
        return winmap

    def __repr__(self):
        mesh = ""
        if self._mesh is not None:
            mesh = f", mesh={dict(self._mesh.shape)}"
        return (
            f"XPySom({self._x}x{self._y}, input_len={self._input_len}, "
            f"topology={self.topology!r}, "
            f"neighborhood={self.neighborhood_func_name!r}, "
            f"distance={self._activation_distance_name!r}{mesh})"
        )

    # -- serialization ---------------------------------------------------------

    def save_checkpoint(self, path, *, epoch=None):
        """Portable .npz checkpoint (codebook + RNG + config header); see
        ``utils.serialization``. Pair with ``train(..., iter_beg=epoch)``
        for resume — the reference's segmented-training mechanism
        (xpysom.py:470-482)."""
        from ..utils.serialization import save_checkpoint

        save_checkpoint(self, path, epoch=epoch)

    @classmethod
    def load_checkpoint(cls, path, *, mesh=None):
        from ..utils.serialization import load_checkpoint

        return load_checkpoint(path, mesh=mesh)

    def __getstate__(self):
        """Pickle support (reference xpysom.py:868-878): drop live device
        handles; everything else is plain host state."""
        from jax.sharding import Mesh

        state = self.__dict__.copy()
        state["_mesh"] = None  # meshes hold device handles; re-resolve on load
        if isinstance(state.get("_mesh_arg"), Mesh):
            # an explicit Mesh holds Device handles: remember only its
            # device count and re-resolve a data mesh on the loading host
            state["_mesh_arg"] = int(state["_mesh_arg"].devices.size)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        # pickles from before the first-class kernel config get defaults
        self.__dict__.setdefault("_use_pallas", True)
        self.__dict__.setdefault("_bmu_precision", "packed")
        self.__dict__.setdefault("_bmu_tiles", None)
        # modes and tile shapes of earlier kernels that no longer exist
        # load as the defaults rather than failing spec validation
        if self._bmu_precision not in core.PRECISIONS:
            self._bmu_precision = "packed"
        if self._bmu_tiles is not None:
            from ..ops.pallas.bmu import validate_blocks

            try:
                self._bmu_tiles = validate_blocks(self._bmu_tiles)
            except ValueError:
                self._bmu_tiles = None
        # pickles from before the *_explicit flags existed: treat every
        # kernel/sizing knob as auto (fresh construction-time resolution
        # on the loading host — the cross-host portability stance of
        # utils/serialization._config_dict); save_checkpoint and
        # _matrix_chunk read these attributes directly
        self.__dict__.setdefault("_use_pallas_explicit", False)
        self.__dict__.setdefault("_bmu_precision_explicit", False)
        self.__dict__.setdefault("_bmu_tiles_explicit", False)
        self.__dict__.setdefault("_n_parallel_explicit", False)
        try:
            self._mesh = resolve_mesh(self._mesh_arg)
        except Exception:
            # Loading host may have fewer devices than the saving host —
            # fall back to single-device, mirroring the reference's
            # backend-fallback on unpickle (xpysom.py:880-892).
            self._mesh = None
            self._mesh_arg = None
