"""Codebook (grid) sharding tests on a 2-D (data, model) virtual mesh:
model-sharded training/inference must match the single-device path."""

import numpy as np
import pytest
import jax

from xpysom_dask_tpu import XPySom
from xpysom_dask_tpu.parallel.grid_sharded import make_grid_mesh


def _mesh(n_data, n_model):
    if len(jax.devices()) < n_data * n_model:
        pytest.skip(f"needs {n_data * n_model} devices")
    return make_grid_mesh(n_data, n_model)


def test_grid_sharded_train_matches_single():
    mesh = _mesh(2, 4)
    rng = np.random.RandomState(0)
    data = rng.rand(600, 5).astype(np.float32)
    single = XPySom(8, 6, 5, random_seed=1, n_parallel=64)
    sharded = XPySom(8, 6, 5, random_seed=1, n_parallel=64, mesh=mesh)
    single.train(data, 4)
    sharded.train(data, 4)
    np.testing.assert_allclose(sharded._weights, single._weights, rtol=1e-4, atol=1e-5)


def test_grid_sharded_inference_matches_single():
    mesh = _mesh(2, 4)
    rng = np.random.RandomState(1)
    data = rng.rand(300, 4).astype(np.float32)
    single = XPySom(4, 7, 4, random_seed=2, n_parallel=32)
    sharded = XPySom(4, 7, 4, random_seed=2, n_parallel=32, mesh=mesh)
    np.testing.assert_array_equal(sharded.predict(data), single.predict(data))
    np.testing.assert_allclose(
        sharded.quantization_error(data), single.quantization_error(data), rtol=1e-6
    )
    np.testing.assert_allclose(
        sharded.topographic_error(data), single.topographic_error(data), rtol=1e-6
    )
    q1 = sharded.quantization(data[:10])
    q2 = single.quantization(data[:10])
    np.testing.assert_array_equal(q1, q2)


def test_grid_sharded_model_only_mesh():
    """Pure model parallelism: 1 data shard x 8 model shards."""
    mesh = _mesh(1, 8)
    rng = np.random.RandomState(2)
    data = rng.rand(256, 3).astype(np.float32)
    single = XPySom(8, 5, 3, random_seed=3, n_parallel=32)
    sharded = XPySom(8, 5, 3, random_seed=3, n_parallel=32, mesh=mesh)
    single.train(data, 3)
    sharded.train(data, 3)
    np.testing.assert_allclose(sharded._weights, single._weights, rtol=1e-4, atol=1e-5)


def test_grid_sharded_verbose_epoch_path():
    mesh = _mesh(2, 2)
    rng = np.random.RandomState(3)
    data = rng.rand(128, 3).astype(np.float32)
    single = XPySom(4, 4, 3, random_seed=4, n_parallel=32)
    sharded = XPySom(4, 4, 3, random_seed=4, n_parallel=32, mesh=mesh)
    import io, contextlib

    buf = io.StringIO()
    single.train(data, 2)
    with contextlib.redirect_stdout(buf):
        sharded.train(data, 2, verbose=True)
    np.testing.assert_allclose(sharded._weights, single._weights, rtol=1e-4, atol=1e-5)


def test_grid_sharded_tie_breaking_first_index():
    """Global argmin across shards must keep NumPy first-index semantics
    even when the winning value appears on several model shards."""
    mesh = _mesh(1, 4)
    som = XPySom(4, 2, 1, random_seed=0, mesh=mesh, std_coeff=1)
    som._weights = np.zeros((4, 2, 1))  # all rows identical -> all tie
    assert som.winner(np.array([0.5])) == (0, 0)
    som._weights[2, 1] = 0.5  # exact match deep in shard 2
    assert som.winner(np.array([0.5])) == (2, 1)


def test_grid_sharded_topographic_error_exact():
    """The 2-D-mesh top-2 merge (per-shard top_k + lexicographic min over
    gathered candidates) must reproduce the single-device TE *exactly* —
    same error count — on rect and hex square maps, trained and untrained,
    including tie-heavy all-equal codebooks."""
    mesh = _mesh(2, 4)
    rng = np.random.RandomState(9)
    data = rng.rand(400, 3).astype(np.float32)
    for topology in ("rectangular", "hexagonal"):
        single = XPySom(8, 8, 3, random_seed=4, n_parallel=64, topology=topology)
        sharded = XPySom(
            8, 8, 3, random_seed=4, n_parallel=64, topology=topology, mesh=mesh
        )
        assert sharded.topographic_error(data) == single.topographic_error(data)
        single.train(data, 3)
        # compare on IDENTICAL trained weights: separately-trained codebooks
        # differ at fp-reassociation level, which flips discrete top-2
        # adjacency on near-ties (the documented chaotic-parity caveat)
        sharded._weights = single._weights.copy()
        assert sharded.topographic_error(data) == single.topographic_error(data)
    # adversarial ties: identical rows across every shard boundary
    tied_s = XPySom(8, 8, 3, random_seed=5, mesh=mesh)
    tied_1 = XPySom(8, 8, 3, random_seed=5)
    tied_s._weights = np.zeros((8, 8, 3))
    tied_1._weights = np.zeros((8, 8, 3))
    assert tied_s.topographic_error(data) == tied_1.topographic_error(data)


def test_grid_mesh_validation():
    mesh = _mesh(1, 4)
    with pytest.raises(ValueError):
        # X=5 not divisible by 4 model shards
        XPySom(5, 4, 2, random_seed=0, mesh=mesh).train(
            np.random.rand(32, 2).astype(np.float32), 1
        )


def test_grid_sharded_streaming_matches_single():
    """Streaming through a (data, model) mesh must equal resident
    single-device training (was previously silently replicated)."""
    mesh = _mesh(2, 2)
    from xpysom_dask_tpu.parallel.pipeline import ArraySource

    rng = np.random.RandomState(7)
    data = rng.rand(512, 4).astype(np.float32)
    single = XPySom(4, 4, 4, random_seed=3, n_parallel=64)
    single.train(data, 3)
    sharded = XPySom(4, 4, 4, random_seed=3, n_parallel=64, mesh=mesh)
    sharded.train(ArraySource(data), 3)
    np.testing.assert_allclose(sharded._weights, single._weights, rtol=1e-4, atol=1e-5)


def test_grid_sharded_te_fused_branch_matches_fallback(monkeypatch):
    """The 2-D TE's fused top-2 branch — per-shard top-2 kernel
    searches + the lexicographic cross-shard
    merge — must equal the lax.top_k fallback. On the CPU the kernel
    gate is closed, so force the branch open and run the kernel in interpret
    mode: the merge glue (value stacking, offset arithmetic, lexmin
    passes) is then exercised on the 8-device CPU mesh; the compiled
    kernel is covered by the degenerate-grid-mesh case in tests_gpu."""
    from xpysom_dask_tpu import core
    from xpysom_dask_tpu.ops.pallas import bmu as pl_bmu
    from xpysom_dask_tpu.parallel import grid_sharded

    mesh = _mesh(2, 4)
    rng = np.random.RandomState(7)
    data = rng.rand(512, 8).astype(np.float32)
    som = XPySom(8, 6, 8, random_seed=3, n_parallel=64, mesh=mesh)
    som.train(data, 3)
    te_fallback = float(som.topographic_error(data))

    real_kind = core._pallas_bmu_kind

    def forced_kind(dist, d_dim, use_pallas=None, mode=None):
        k = real_kind(dist, d_dim, use_pallas, mode)
        return "euclidean" if (k is None and dist.name == "euclidean") else k

    monkeypatch.setattr(core, "_pallas_bmu_kind", forced_kind)
    calls = {"n": 0}
    real_searcher = pl_bmu.searcher

    def counting_interpret_searcher(*a, **kw):
        calls["n"] += 1
        return real_searcher(*a, interpret=True, **kw)

    monkeypatch.setattr(pl_bmu, "searcher", counting_interpret_searcher)
    # a distinct spec defeats the factory's lru_cache (same map, new
    # sigmaN) so the forced-open gate actually rebuilds the program
    som2 = XPySom(8, 6, 8, random_seed=3, n_parallel=64, mesh=mesh,
                  sigmaN=0.9999)
    som2._weights = som.get_weights().copy()
    te_fused = float(som2.topographic_error(data))
    assert calls["n"] > 0, "fused top-2 branch was not taken"
    assert te_fused == pytest.approx(te_fallback, abs=1e-9)
