#!/usr/bin/env python
"""End-to-end SOM training benchmark CLI.

No counterpart in the reference (its benchmarks only cover kernels); this
measures what actually matters — samples/sec of the full training step —
across configurable shapes, including the BASELINE.json north-star shape
(128×128 codebook, D=64).
"""

import argparse
import sys

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from xpysom_dask_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from benchmarks.bench_utils import bench  # noqa: E402
from xpysom_dask_tpu.core import SomSpec, chunk_data, make_train_fn  # noqa: E402


def main():
    enable_compile_cache()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-x", type=int, default=128)
    ap.add_argument("-y", type=int, default=128)
    ap.add_argument("-d", type=int, default=64)
    ap.add_argument("-n", type=int, default=1 << 18, help="samples per epoch")
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("-r", type=int, default=5)
    ap.add_argument("--epochs-per-rep", type=int, default=10,
                    help="epochs per timed dispatch (amortizes the "
                         "per-dispatch latency)")
    ap.add_argument("--neighborhood", default="gaussian")
    ap.add_argument("--topology", default="rectangular")
    ap.add_argument("--mesh", type=int, default=0,
                    help="data-parallel over this many devices (0 = off)")
    ap.add_argument("--model", type=int, default=0,
                    help="additionally shard the codebook over this many model shards")
    args = ap.parse_args()

    spec = SomSpec(
        x=args.x,
        y=args.y,
        input_len=args.d,
        sigma=min(args.x, args.y) / 2,
        sigmaN=1.0,
        learning_rate=0.5,
        learning_rateN=0.01,
        neighborhood=args.neighborhood,
        topology=args.topology,
    )
    rng = np.random.RandomState(0)
    mesh = None
    n_shards = 1
    if args.model:
        from xpysom_dask_tpu.parallel.grid_sharded import make_grid_mesh

        mesh = make_grid_mesh(max(args.mesh, 1), args.model)
        n_shards = max(args.mesh, 1)
    elif args.mesh:
        from xpysom_dask_tpu.parallel.mesh import make_data_mesh

        mesh = make_data_mesh(args.mesh)
        n_shards = args.mesh

    chunks, mask, _ = chunk_data(
        rng.rand(args.n, args.d).astype(np.float32), args.chunk, multiple_of=n_shards
    )
    if mesh is not None:
        from xpysom_dask_tpu.parallel.grid_sharded import codebook_sharding, is_grid_mesh
        from xpysom_dask_tpu.parallel.mesh import data_sharding, replicated_sharding

        chunks = jax.device_put(chunks, data_sharding(mesh))
        mask = jax.device_put(mask, data_sharding(mesh))
        w_sharding = (
            codebook_sharding(mesh) if is_grid_mesh(mesh) else replicated_sharding(mesh)
        )
        w = jax.device_put(
            rng.rand(args.x, args.y, args.d).astype(np.float32), w_sharding
        )
    else:
        chunks = jnp.asarray(chunks)
        mask = jnp.asarray(mask)
        w = jnp.asarray(rng.rand(args.x, args.y, args.d).astype(np.float32))

    k = max(1, args.epochs_per_rep)
    schedule = max(100, (args.r + 2) * k + 1)
    # K epochs in ONE dispatch on EVERY path — the mesh paths must
    # amortize per-dispatch latency exactly like the single-device path or
    # mesh-vs-single comparisons are biased by (k-1) extra dispatches
    if mesh is not None:
        # is_grid_mesh already bound by the sharding block above
        if is_grid_mesh(mesh):
            from xpysom_dask_tpu.parallel.grid_sharded import make_train_fn_2d

            train_fn = make_train_fn_2d(spec, schedule, mesh)
        else:
            train_fn = make_train_fn(spec, schedule, mesh)
    else:
        train_fn = make_train_fn(spec, schedule)

    def run_k(w, chunks, mask):
        return train_fn(w, chunks, mask, jnp.int32(1), jnp.int32(1 + k))

    # train_fn donates the codebook, so each call needs a fresh buffer —
    # pre-copied OUTSIDE the timed region (an in-region copy adds a
    # dispatch + a full codebook copy to every rep's timing)
    warmup = 2
    copies = [jnp.array(w, copy=True) for _ in range(warmup + args.r)]

    def run(chunks, mask):
        return run_k(copies.pop(), chunks, mask)

    mesh_desc = (
        "off" if mesh is None
        else f"data={n_shards}" + (f" model={args.model}" if args.model else "")
    )
    print(
        f"backend={jax.default_backend()} som={args.x}x{args.y}x{args.d} "
        f"n={args.n} chunk={args.chunk} mesh={mesh_desc} epochs/rep={k}"
    )
    res = bench(
        run, chunks, mask, name=f"{k} epochs", reps=args.r, warmup=warmup
    )
    print(res)
    print(f"throughput (min-based): {args.n * k / res.min:,.0f} samples/s")


if __name__ == "__main__":
    main()
