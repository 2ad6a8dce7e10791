"""Out-of-core input pipeline for huge-N training.

The reference scales past memory via user-provided Dask arrays whose chunks
are shipped to workers per epoch (reference xpysom.py:545-558). The
equivalent here: stream *superbatches* from host (or disk, via
``np.memmap`` or the native C++ chunk loader) into device memory while the
previous superbatch computes, folding per-BMU sufficient statistics on
device. Because the batch-SOM update is a pure reduction over samples
(SURVEY.md §0 math), epoch = fold(stats over superbatches) → one codebook
update; streaming is numerically identical to the resident path up to fp
reassociation.

Overlap comes from JAX async dispatch: ``device_put`` of superbatch ``k+1``
and host-side disk reads run while the device crunches superbatch ``k``.

At north-star scale (10⁸×64 fp32 = 25.6 GB) the data need not fit on the
device; this pipeline keeps it fed from host RAM/disk (SURVEY.md §7 risk
"huge-N data motion").
"""

from __future__ import annotations

from typing import Iterator, Optional, Protocol

import jax
import jax.numpy as jnp
import numpy as np

from ..core import SomSpec, chunk_data, make_stats_fn, make_update_fn
from .mesh import data_sharding, replicated_sharding

__all__ = [
    "DataSource",
    "ArraySource",
    "FileSource",
    "IterableSource",
    "ShardedFileSource",
    "train_streaming",
    "stats_streaming",
    "default_superbatch_rows",
    "fold_stats",
]


class DataSource(Protocol):
    """Anything that can hand out ``(N_i, D)`` float32 superbatches."""

    def __len__(self) -> int: ...

    def superbatches(self, rows: int) -> Iterator[np.ndarray]: ...


def _check_rows(rows: int) -> int:
    """Superbatch size must be positive — 0 would make every source
    yield an immediate empty epoch (the native loader would deliver a
    silent rows==0 EOF; ArraySource's range() would raise a cryptic
    step error), so the contract is enforced once, eagerly, here."""
    rows = int(rows)
    if rows <= 0:
        raise ValueError(f"superbatch rows must be positive, got {rows}")
    return rows


class ArraySource:
    """DataSource over an in-memory array or ``np.memmap`` (rows are read
    lazily, so a 25 GB memmap never fully materializes in host RAM)."""

    def __init__(self, array):
        if array.ndim != 2:
            raise ValueError(f"expected (N, D) data, got shape {array.shape}")
        self.array = array

    def __len__(self):
        return self.array.shape[0]

    @property
    def dim(self):
        return self.array.shape[1]

    def superbatches(self, rows: int) -> Iterator[np.ndarray]:
        rows = _check_rows(rows)
        n = self.array.shape[0]
        for start in range(0, n, rows):
            block = np.asarray(self.array[start : start + rows], dtype=np.float32)
            yield block


class IterableSource:
    """DataSource over any re-iterable batch producer — a callable
    returning an iterator of ``(n_i, D)`` arrays per epoch. Adapts external
    input pipelines (grain datasets, tf.data, generators) to the streaming
    trainer; batches are re-blocked to the requested superbatch size.

    ``factory`` is called once per epoch, so the producer may reshuffle or
    re-read between epochs.
    """

    def __init__(self, factory, n_rows: int, n_cols: int):
        self.factory = factory
        self.n_rows = int(n_rows)
        self.n_cols = int(n_cols)

    def __len__(self):
        return self.n_rows

    @property
    def dim(self):
        return self.n_cols

    def superbatches(self, rows: int) -> Iterator[np.ndarray]:
        rows = _check_rows(rows)
        pending = []
        have = 0
        for batch in self.factory():
            batch = np.asarray(batch, dtype=np.float32)
            if batch.ndim != 2 or batch.shape[1] != self.n_cols:
                raise ValueError(
                    f"expected (n, {self.n_cols}) batches, got {batch.shape}"
                )
            pending.append(batch)
            have += batch.shape[0]
            while have >= rows:
                block = np.concatenate(pending) if len(pending) > 1 else pending[0]
                yield block[:rows]
                rest = block[rows:]
                pending = [rest] if rest.shape[0] else []
                have = rest.shape[0]
        if have:
            yield np.concatenate(pending) if len(pending) > 1 else pending[0]


class FileSource:
    """DataSource over a raw binary file of float32 rows, backed by the
    native C++ chunk loader (``csrc/chunkloader.cpp``): a background reader
    thread double-buffers superbatches so disk I/O overlaps device compute.
    Falls back to ``np.memmap`` slicing when the native library is
    unavailable (no toolchain)."""

    def __init__(self, path, n_rows: int, n_cols: int, *, n_buffers: int = 3):
        self.path = str(path)
        self.n_rows = int(n_rows)
        self.n_cols = int(n_cols)
        self.n_buffers = int(n_buffers)
        from ..utils.native import load_chunkloader

        self._lib = load_chunkloader()

    def __len__(self):
        return self.n_rows

    @property
    def dim(self):
        return self.n_cols

    def _superbatches_native(self, rows: int) -> Iterator[np.ndarray]:
        import ctypes

        lib = self._lib
        h = lib.xs_open(
            self.path.encode(), self.n_rows, self.n_cols, rows, self.n_buffers
        )
        if not h:
            raise OSError(f"native loader failed to open {self.path}")
        try:
            while True:
                got = ctypes.c_int64(0)
                ptr = lib.xs_acquire(h, ctypes.byref(got))
                if got.value < 0:
                    err_fn = getattr(lib, "xs_error", None)
                    detail = (
                        (err_fn(h) or b"").decode(errors="replace")
                        if err_fn
                        else ""
                    ) or f"read error on {self.path}"
                    raise OSError(f"native loader: {detail}")
                if got.value == 0:
                    break
                # Copy out of the ring buffer (the view dies at release);
                # device_put would copy anyway.
                block = np.ctypeslib.as_array(
                    ptr, shape=(got.value, self.n_cols)
                ).copy()
                lib.xs_release(h)
                yield block
        finally:
            lib.xs_close(h)

    def superbatches(self, rows: int) -> Iterator[np.ndarray]:
        rows = _check_rows(rows)
        if self._lib is not None:
            yield from self._superbatches_native(rows)
            return
        mm = np.memmap(
            self.path, dtype=np.float32, mode="r", shape=(self.n_rows, self.n_cols)
        )
        yield from ArraySource(mm).superbatches(rows)


class ShardedFileSource:
    """DataSource over MANY raw float32 shard files, multi-host aware:
    each process streams only its round-robin slice of the file list
    (``files[process_id::num_processes]``), so a multi-host data-parallel
    run (``initialize_multihost`` + ``mesh='auto'``) reads disjoint data
    — the replacement for the reference shipping per-worker
    Dask chunks from the driver (xpysom.py:545-558): every host pulls
    its own shards straight from storage. Cross-host traffic during the
    epoch is the per-superbatch statistics ``psum`` plus one tiny
    row-count allgather per superbatch (``_synced_superbatches`` keeps
    superbatch counts/shapes aligned so ragged shard totals cannot
    desync the collectives).

    Shard row counts are inferred from file sizes (must be whole float32
    rows of ``n_cols``). Each shard streams through :class:`FileSource`
    (the native double-buffered C++ loader when available), and blocks
    are re-joined across shard boundaries so superbatches keep the
    requested size.

    ``process_id``/``num_processes`` default to the live JAX process
    topology; pass them explicitly for testing or external launchers."""

    def __init__(
        self,
        files,
        n_cols: int,
        *,
        process_id=None,
        num_processes=None,
        n_buffers: int = 3,
    ):
        files = [str(f) for f in files]
        if not files:
            raise ValueError("ShardedFileSource needs at least one file")
        if process_id is None:
            process_id = jax.process_index()
        if num_processes is None:
            num_processes = jax.process_count()
        if not (0 <= int(process_id) < int(num_processes)):
            raise ValueError(
                f"process_id {process_id} out of range for "
                f"{num_processes} processes"
            )
        self.n_cols = int(n_cols)
        self.files = files[int(process_id) :: int(num_processes)]
        self._sources = []
        import os as _os

        for f in self.files:
            size = _os.path.getsize(f)
            row_bytes = 4 * self.n_cols
            if size % row_bytes:
                raise ValueError(
                    f"{f}: {size} bytes is not a whole number of "
                    f"float32 rows of {self.n_cols} columns"
                )
            self._sources.append(
                FileSource(f, size // row_bytes, self.n_cols, n_buffers=n_buffers)
            )

    def __len__(self):
        return sum(len(s) for s in self._sources)

    @property
    def dim(self):
        return self.n_cols

    def superbatches(self, rows: int) -> Iterator[np.ndarray]:
        if not self._sources:  # more processes than shards: empty shard
            return

        def gen():
            for s in self._sources:
                yield from s.superbatches(rows)

        # IterableSource re-blocks across shard boundaries so every
        # superbatch (except the tail) is exactly `rows` tall
        yield from IterableSource(gen, len(self), self.n_cols).superbatches(rows)


def default_superbatch_rows(d: int) -> int:
    """~256 MB device-resident superbatch block, scaled by feature width
    and clamped to [4096, 2^22] rows — the ONE sizing rule shared by the
    single-model streaming paths (train/inference) and the population
    sweep's streaming fold."""
    return max(4096, min(1 << 22, (1 << 28) // (4 * max(int(d), 1))))


@jax.jit
def fold_stats(a, b):
    """Elementwise tree-add of two sufficient-statistics pytrees (the
    superbatch fold), shared by every streaming accumulator."""
    return jax.tree.map(jnp.add, a, b)


def _put(arr, mesh, sharded: bool):
    """Device-put for the streaming paths. ``sharded=True`` means the
    array is PER-PROCESS-DISTINCT data (each host streamed its own rows
    — ``put_process_local`` assembles the global batch in process
    order); ``sharded=False`` means every process holds the identical
    full array (codebooks)."""
    from .mesh import put_process_local, put_with_sharding

    if mesh is None:
        return jnp.asarray(arr)
    if sharded:
        return put_process_local(arr, data_sharding(mesh))
    return put_with_sharding(arr, replicated_sharding(mesh))


def _synced_superbatches(source, rows: int, dim: int, chunk: int, local_mult: int):
    """Yield ``(block, min_chunks)`` pairs, SYNCHRONIZED across processes
    in a multi-host run: every process yields the same number of pairs
    per epoch, and ``min_chunks`` is the cross-process-agreed local chunk
    count (max need, rounded up to ``local_mult``), so each process's
    ``chunk_data`` output has the identical shape every step — the
    per-superbatch ``psum`` collectives and compiled program shapes then
    line up exactly. Hosts that run out of rows (ragged shard totals,
    or more processes than shards) contribute empty, fully-masked
    blocks until every host is done; one tiny host-level allgather of
    the local row count per step is the only coordination.

    Single-process: plain pass-through (``min_chunks=1``)."""
    if jax.process_count() == 1:
        for block in source.superbatches(rows):
            yield block, 1
        return
    from jax.experimental import multihost_utils

    it = iter(source.superbatches(rows))
    while True:
        block = next(it, None)
        n = -1 if block is None else int(block.shape[0])
        counts = multihost_utils.process_allgather(np.asarray([n], np.int64))
        if int(counts.max()) < 0:
            return  # every process is done
        if block is None:
            block = np.zeros((0, dim), np.float32)
        needs = np.maximum(1, -(-np.maximum(counts, 0) // chunk))
        k = int(needs.max())
        yield block, -(-k // local_mult) * local_mult


def _local_chunk_multiple(mesh, n_data: int) -> int:
    """Chunks each PROCESS must produce a multiple of so the global batch
    (``local · process_count`` chunks) shards evenly over the mesh's
    ``data`` axis. Assumes the data axis splits evenly across processes
    (the standard equal-devices-per-host topology)."""
    return max(1, n_data // jax.process_count())


def _is_grid(mesh):
    from .grid_sharded import is_grid_mesh

    return is_grid_mesh(mesh)


def _put_codebook(w, mesh):
    from .mesh import put_with_sharding

    if mesh is None:
        return jnp.asarray(w)
    if _is_grid(mesh):
        from .grid_sharded import codebook_sharding

        return put_with_sharding(w, codebook_sharding(mesh))
    return put_with_sharding(w, replicated_sharding(mesh))


def stats_streaming(
    spec: SomSpec,
    w,
    source: DataSource,
    chunk: int,
    superbatch_rows: int,
    mesh=None,
    stats_fn=None,
):
    """One epoch's sufficient statistics folded over streamed
    superbatches. ``w`` must already live on device (replicated, or
    codebook-sharded on a (data, model) mesh — the statistics then stay
    sharded over 'model').

    ``stats_fn`` overrides the compiled accumulator (``stats(w, data,
    mask) -> stats-pytree``) — the population sweep passes its own so
    the multi-host superbatch synchronization lives in exactly one
    place; the default builds the single-model one from ``spec``. On one
    device that one continues its scan from superbatch to superbatch, so
    the epoch adds its chunks in the order of the resident epoch and,
    where the device's scatter is deterministic, equals it to the bit."""
    carry = mesh is None and stats_fn is None
    if mesh is not None and _is_grid(mesh):
        n_data = int(mesh.shape["data"])
        if stats_fn is None:
            from .grid_sharded import make_stats_fn_2d

            stats_fn = make_stats_fn_2d(spec, mesh)
    else:
        n_data = mesh.devices.size if mesh is not None else 1
        if stats_fn is None:
            stats_fn = make_stats_fn(spec, mesh)
    # each PROCESS chunks to a multiple of its data-axis share; the
    # assembled global batch is then a multiple of the full data axis
    local_mult = _local_chunk_multiple(mesh, n_data) if mesh is not None else 1
    d = getattr(source, "dim", spec.input_len)
    # The per-process-distinct transport (put_process_local) shards the
    # global batch over the data axis in process order — that requires
    # the data axis to split evenly across processes. A mesh whose data
    # axis cannot (a model-spanning grid(1, n), or more processes than
    # data shards) instead HOST-GATHERS the synced, shape-agreed chunk
    # blocks so every process holds the identical global batch; the
    # identical-everywhere put then applies. The gather rides the same
    # per-superbatch cadence as the count sync above it.
    host_gather = (
        mesh is not None
        and jax.process_count() > 1
        and n_data % jax.process_count() != 0
    )

    s = cnt = None
    for block, k in _synced_superbatches(
        source, superbatch_rows, d, chunk, local_mult
    ):
        chunks, mask, _ = chunk_data(
            block, chunk, multiple_of=local_mult, min_chunks=k
        )
        if host_gather:
            from jax.experimental import multihost_utils

            from .mesh import put_with_sharding

            chunks = multihost_utils.process_allgather(chunks, tiled=True)
            mask = multihost_utils.process_allgather(mask, tiled=True)
            pad = (-chunks.shape[0]) % n_data  # data-axis divisibility
            if pad:
                chunks = np.concatenate(
                    [chunks, np.zeros((pad,) + chunks.shape[1:], chunks.dtype)]
                )
                mask = np.concatenate(
                    [mask, np.zeros((pad,) + mask.shape[1:], mask.dtype)]
                )
            chunks = put_with_sharding(chunks, data_sharding(mesh))
            mask = put_with_sharding(mask, data_sharding(mesh))
        else:
            chunks = _put(chunks, mesh, sharded=True)
            mask = _put(mask, mesh, sharded=True)
        if carry and s is not None:
            part = stats_fn(w, chunks, mask, (s, cnt))
        else:
            part = stats_fn(w, chunks, mask)
        if carry or s is None:
            s, cnt = part
        else:
            s, cnt = fold_stats((s, cnt), part)
    if s is None:
        raise ValueError("empty data source")
    return s, cnt


def train_streaming(
    spec: SomSpec,
    weights: np.ndarray,
    source: DataSource,
    num_epochs: int,
    *,
    iter_beg: int = 0,
    iter_end: Optional[int] = None,
    chunk: int = 8192,
    superbatch_rows: Optional[int] = None,
    mesh=None,
    progress=None,
) -> np.ndarray:
    """Full streamed training: per epoch, fold stats over superbatches then
    apply one codebook update (identical semantics to the resident path /
    the reference's per-epoch accumulate-then-merge, xpysom.py:515-577).

    ``superbatch_rows`` defaults to a ~256 MB device-resident block
    (scaled by the feature width), clamped to [4096, 2^22] rows."""
    if iter_end is None:
        iter_end = num_epochs
    if superbatch_rows is None:
        superbatch_rows = default_superbatch_rows(
            getattr(source, "dim", spec.input_len)
        )
    superbatch_rows = _check_rows(superbatch_rows)
    # the SAME training-branch sizing the resident path applies
    # (utils.hw.training_chunk): whole kernel row blocks, so no chunk
    # pads per scan step
    from ..utils.hw import training_chunk

    chunk = training_chunk(superbatch_rows, chunk)
    if mesh is not None and _is_grid(mesh):
        from .grid_sharded import make_update_fn_2d

        update_fn = make_update_fn_2d(spec, num_epochs, mesh)
    else:
        update_fn = make_update_fn(spec, num_epochs)
    w = _put_codebook(np.asarray(weights, dtype=np.float32), mesh)
    for t in range(iter_beg, iter_end):
        s, cnt = stats_streaming(spec, w, source, chunk, superbatch_rows, mesh)
        w = update_fn(w, s, cnt, jnp.int32(t))
        if progress is not None:
            progress(t)
    from .mesh import fetch_global

    return fetch_global(w)
