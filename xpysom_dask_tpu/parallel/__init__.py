"""Distribution layer: device meshes, shardings and data pipelines — the
replacement of the reference's inline Dask branches
(xpysom.py:545-558)."""

from .grid_sharded import codebook_sharding, is_grid_mesh, make_grid_mesh
from .mesh import (
    data_sharding,
    initialize_multihost,
    make_data_mesh,
    put_process_local,
    put_with_sharding,
    replicated_sharding,
    resolve_mesh,
)
from .pipeline import (
    ArraySource,
    FileSource,
    IterableSource,
    ShardedFileSource,
    stats_streaming,
    train_streaming,
)

__all__ = [
    "initialize_multihost",
    "make_data_mesh",
    "make_grid_mesh",
    "is_grid_mesh",
    "resolve_mesh",
    "data_sharding",
    "replicated_sharding",
    "codebook_sharding",
    "ArraySource",
    "FileSource",
    "IterableSource",
    "ShardedFileSource",
    "stats_streaming",
    "train_streaming",
    "put_with_sharding",
    "put_process_local",
]
