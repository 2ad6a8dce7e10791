"""Worker for the 2-process jax.distributed (DCN-analog) test.

Spawned by tests/test_multihost.py with argv = (process_id, num_processes,
coordinator_port). Each process brings 2 virtual CPU devices; together
they form a 4-device 'data' mesh spanning both processes — the
multi-host layout of ``parallel.mesh.initialize_multihost`` (the
rebuild's answer to the reference's user-owned dask.distributed.Client,
README.md:52-59). Verifies that the psum of per-shard sufficient
statistics across processes equals the single-process result.
"""

import os
import sys

# ``python tests/multihost_worker.py`` puts tests/ on sys.path, not the
# repo root — add it so the package imports.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Env must be set before jax import (the parent also sets these; keep the
# worker self-sufficient so it can be run by hand).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    from xpysom_dask_tpu.core import SomSpec, chunk_data, make_stats_fn
    from xpysom_dask_tpu.parallel.mesh import (
        data_sharding,
        initialize_multihost,
        make_data_mesh,
    )

    initialize_multihost(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nprocs,
        process_id=pid,
    )
    assert jax.process_count() == nprocs, jax.process_count()
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    assert n_global == n_local * nprocs, (n_global, n_local)

    mesh = make_data_mesh()  # spans every process
    spec = SomSpec(
        x=6,
        y=5,
        input_len=4,
        sigma=3.0,
        sigmaN=1.0,
        learning_rate=0.5,
        learning_rateN=0.01,
    )

    # identical data everywhere; each process materializes only the shards
    # its local devices own (make_array_from_callback slices per device)
    rng = np.random.RandomState(0)
    data = rng.rand(256, spec.input_len).astype(np.float32)
    w = rng.rand(spec.x, spec.y, spec.input_len).astype(np.float32)
    chunks, mask, _ = chunk_data(data, 16, multiple_of=n_global)

    sh = data_sharding(mesh)
    g_chunks = jax.make_array_from_callback(
        chunks.shape, sh, lambda idx: chunks[idx]
    )
    g_mask = jax.make_array_from_callback(mask.shape, sh, lambda idx: mask[idx])
    from xpysom_dask_tpu.parallel.mesh import replicated_sharding

    g_w = jax.make_array_from_callback(
        w.shape, replicated_sharding(mesh), lambda idx: w[idx]
    )

    s, cnt = make_stats_fn(spec, mesh)(g_w, g_chunks, g_mask)

    # single-process oracle on this host's default device
    s1, cnt1 = make_stats_fn(spec, None)(
        jnp.asarray(w), jnp.asarray(chunks), jnp.asarray(mask)
    )
    np.testing.assert_allclose(
        np.asarray(jax.device_get(s)), np.asarray(s1), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(jax.device_get(cnt)), np.asarray(cnt1), rtol=0, atol=0
    )
    # --- round 4: streamed multi-host training parity -------------------
    # Each process streams a DIFFERENT, UNEQUALLY-SIZED slice (the
    # ShardedFileSource scenario): process 0 gets 180 rows, process 1
    # gets 120, so superbatch counts differ (3 vs 2 at rows=64) and the
    # sync layer must pad the short host with empty blocks, agree chunk
    # counts per step, and assemble per-process-local data in process
    # order. The result must equal a single-device resident train on the
    # concatenation.
    from xpysom_dask_tpu.core import make_train_fn
    from xpysom_dask_tpu.parallel.pipeline import ArraySource, train_streaming

    full = rng.rand(300, spec.input_len).astype(np.float32)
    splits = [full[:180], full[180:]]
    w0 = rng.rand(spec.x, spec.y, spec.input_len).astype(np.float32)

    w_stream = train_streaming(
        spec,
        w0,
        ArraySource(splits[pid]),
        num_epochs=3,
        chunk=16,
        superbatch_rows=64,
        mesh=mesh,
    )
    chunks_f, mask_f, _ = chunk_data(full, 16)
    w_ref = make_train_fn(spec, 3)(
        jnp.asarray(w0),
        jnp.asarray(chunks_f),
        jnp.asarray(mask_f),
        jnp.int32(0),
        jnp.int32(3),
    )
    np.testing.assert_allclose(
        np.asarray(w_stream), np.asarray(w_ref), rtol=1e-4, atol=1e-5
    )
    print(f"MULTIHOST_STREAM_OK pid={pid}", flush=True)

    # --- round 4: 2-D (data, model) mesh spanning processes --------------
    # data axis across hosts, codebook sharded over the model axis within
    # each host's devices; same ragged streamed input, same oracle.
    from xpysom_dask_tpu.parallel.grid_sharded import make_grid_mesh

    mesh2 = make_grid_mesh(nprocs, n_local)
    w_stream2 = train_streaming(
        spec,
        w0,
        ArraySource(splits[pid]),
        num_epochs=3,
        chunk=16,
        superbatch_rows=64,
        mesh=mesh2,
    )
    np.testing.assert_allclose(
        np.asarray(w_stream2), np.asarray(w_ref), rtol=1e-4, atol=1e-5
    )
    print(f"MULTIHOST_GRID_STREAM_OK pid={pid}", flush=True)

    # --- round 5: resident inference over the multi-host mesh ------------
    # predict/winner return per-row outputs sharded P('data') across
    # processes; the np.asarray boundary must gather them onto every host
    # (review finding: it raised on non-addressable arrays before).
    from xpysom_dask_tpu import XPySom

    som_mesh = XPySom(6, 5, 4, sigma=2.0, random_seed=7, mesh=mesh)
    som_one = XPySom(6, 5, 4, sigma=2.0, random_seed=7)  # same codebook
    pred_mesh = som_mesh.predict(full)
    pred_one = som_one.predict(full)
    np.testing.assert_array_equal(pred_mesh, pred_one)
    assert som_mesh.winner(full[:3]) == som_one.winner(full[:3])
    print(f"MULTIHOST_INFER_OK pid={pid}", flush=True)

    # --- round 5: model axis SPANNING processes ---------------------------
    # make_grid_mesh(1, n_global) puts the codebook's P('model') shards on
    # devices of BOTH processes: the trained weights are non-addressable
    # from either one, so every train/checkpoint write-back must gather via
    # fetch_global (process_allgather) — jax.device_get raised here before
    # (round-5 review finding). The earlier mesh2 = (nprocs, n_local) never
    # caught this: its model axis stays within one host, so data-axis
    # replicas keep each model shard locally addressable.
    import tempfile

    mesh3 = make_grid_mesh(1, n_global)
    spec8 = SomSpec(
        x=8,  # divides the n_global model shards (spec.x=6 would not)
        y=5,
        input_len=4,
        sigma=3.0,
        sigmaN=1.0,
        learning_rate=0.5,
        learning_rateN=0.01,
    )
    w0_8 = rng.rand(spec8.x, spec8.y, spec8.input_len).astype(np.float32)
    # streamed write-back (parallel/pipeline.py tail)
    w_stream3 = train_streaming(
        spec8,
        w0_8,
        ArraySource(splits[pid]),
        num_epochs=3,
        chunk=16,
        superbatch_rows=64,
        mesh=mesh3,
    )
    chunks8, mask8, _ = chunk_data(full, 16)
    w_ref8 = make_train_fn(spec8, 3)(
        jnp.asarray(w0_8),
        jnp.asarray(chunks8),
        jnp.asarray(mask8),
        jnp.int32(0),
        jnp.int32(3),
    )
    np.testing.assert_allclose(
        np.asarray(w_stream3), np.asarray(w_ref8), rtol=1e-4, atol=1e-5
    )
    # resident public-API train with a mid-run checkpoint (models/som.py
    # write-back at the checkpoint boundary AND at the end of train)
    ckpt = os.path.join(tempfile.gettempdir(), f"mh_modelspan_{port}.npz")
    som_span = XPySom(8, 5, 4, sigma=2.0, random_seed=11, mesh=mesh3)
    som_ref = XPySom(8, 5, 4, sigma=2.0, random_seed=11)
    som_span.train(full, 2, checkpoint_path=ckpt, checkpoint_every=1)
    som_ref.train(full, 2)
    np.testing.assert_allclose(
        som_span.get_weights(), som_ref.get_weights(), rtol=1e-4, atol=1e-5
    )
    if pid == 0:
        assert os.path.exists(ckpt), ckpt
        os.remove(ckpt)
    print(f"MULTIHOST_MODELSPAN_OK pid={pid}", flush=True)

    print(f"MULTIHOST_OK pid={pid} devices={n_global}", flush=True)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
