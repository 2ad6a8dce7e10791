"""Device-mesh construction for data-parallel SOM training.

The reference's distribution layer is ~40 lines of inline Dask branches
(``xpysom_dask/xpysom.py:545-558,614-617,693-696``): per-chunk delayed
tasks, codebook re-shipped to every task, accumulators reduced on the
driver each epoch. Here distribution is a real layer: a 1-D
``jax.sharding.Mesh`` with a ``'data'`` axis; epoch steps are
``shard_map``-wrapped pure functions (see ``core.py``) whose per-shard
sufficient statistics are ``psum``-reduced by collectives (NVLink
between the cards of a host) with zero driver involvement.
"""

from __future__ import annotations

from typing import Optional, Union

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_data_mesh",
    "resolve_mesh",
    "data_sharding",
    "replicated_sharding",
    "initialize_multihost",
    "put_with_sharding",
    "put_process_local",
    "fetch_global",
]

DATA_AXIS = "data"


def initialize_multihost(coordinator_address=None, num_processes=None, process_id=None):
    """Join a multi-host run.

    Thin wrapper over ``jax.distributed.initialize`` — call once per host
    before building meshes; afterwards ``jax.devices()`` spans every host
    and ``make_data_mesh()`` / ``make_grid_mesh()`` lay the ``data`` axis
    across hosts, so the per-epoch ``psum`` of sufficient statistics spans
    every host (the reference's closest analog is
    pointing ``dask.distributed`` at a multi-node cluster,
    README.md:52-59 — here the runtime is JAX's own).

    With no arguments, JAX looks for a cluster in the environment; on a
    plain GPU host pass ``coordinator_address`` (``host:port``),
    ``num_processes`` and ``process_id`` explicitly.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def make_data_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """Create a 1-D mesh over ``n_devices`` (default: all local devices)
    with the single axis ``'data'``."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} available"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def resolve_mesh(mesh: Union[None, bool, int, str, Mesh]) -> Optional[Mesh]:
    """Normalize the user-facing ``mesh`` argument:

    - ``None``/``False`` → single-device execution (no mesh),
    - ``True``/``'auto'`` → mesh over all local devices,
    - int ``k`` → mesh over the first ``k`` local devices,
    - a ``jax.sharding.Mesh`` → used as-is (must carry a ``'data'`` axis).
    """
    if mesh is None or mesh is False:
        return None
    if mesh is True or (isinstance(mesh, str) and mesh == "auto"):
        return make_data_mesh()
    if isinstance(mesh, int):
        return make_data_mesh(mesh)
    if isinstance(mesh, Mesh):
        if DATA_AXIS not in mesh.axis_names:
            raise ValueError(f"mesh must have a {DATA_AXIS!r} axis, got {mesh.axis_names}")
        return mesh
    raise TypeError(f"cannot interpret mesh argument {mesh!r}")


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding that splits the leading (chunk) axis over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def mesh_spans_processes(mesh) -> bool:
    """True when ``mesh`` contains devices owned by another process
    (a multi-host mesh)."""
    if mesh is None or jax.process_count() == 1:
        return False
    me = jax.process_index()
    return any(d.process_index != me for d in mesh.devices.flat)


def put_with_sharding(arr, sharding):
    """``device_put`` that also works in MULTI-PROCESS runs for arrays
    every process holds in full (codebooks, resident datasets): a plain
    ``device_put`` cannot target non-addressable devices, so under
    ``jax.process_count() > 1`` this routes through
    ``make_array_from_callback`` — each process materializes exactly the
    global slices its local devices own. Single-process: plain put."""
    import numpy as np

    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    arr = np.asarray(arr)
    return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])


def fetch_global(arr) -> np.ndarray:
    """Fetch an array's GLOBAL value onto every host as numpy.

    The training write-back dual of ``put_with_sharding``:
    ``jax.device_get`` raises on arrays with non-addressable shards —
    e.g. the ``P('model')``-sharded codebook of a multi-host grid mesh
    (``grid_sharded.codebook_sharding``) at the end of ``train`` or at a
    checkpoint boundary. Inference already gathers its ``P('data')``
    outputs via ``process_allgather`` (``models/som.py``); this routes
    host-spanning TRAINING outputs (codebooks, accumulators) through the
    same collective — for a non-fully-addressable input it returns the
    fully-replicated global value. Fully-addressable or replicated
    arrays (single process, 1-D data mesh) take the plain
    ``device_get`` path unchanged.
    """
    if (
        not isinstance(arr, jax.Array)
        or jax.process_count() == 1
        or arr.is_fully_addressable
        or arr.is_fully_replicated
    ):
        return np.asarray(jax.device_get(arr))
    from jax.experimental import multihost_utils

    # tiled=True is REQUIRED for global non-fully-addressable inputs;
    # the result is the fully-replicated global value either way
    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))


def put_process_local(arr, sharding):
    """Assemble a global array from PER-PROCESS-DISTINCT local data (the
    streaming shards path: each host read different rows). ``arr`` is
    this process's contribution; the global leading dim is
    ``local · process_count``, mapped in process order by
    ``make_array_from_process_local_data``. Every process must pass the
    SAME local shape (the callers' superbatch synchronization
    guarantees it). Single-process: plain put."""
    import numpy as np

    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    arr = np.asarray(arr)
    gshape = (arr.shape[0] * jax.process_count(),) + arr.shape[1:]
    return jax.make_array_from_process_local_data(sharding, arr, gshape)
