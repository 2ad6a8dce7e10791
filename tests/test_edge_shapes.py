"""Edge-shape coverage: 1-D ring grids (the TSP workload, SURVEY §2.9),
single-feature data, tiny chunks, non-square grids."""

import numpy as np

from xpysom_dask_tpu.utils.hw import ROW_BLOCK
import pytest

from xpysom_dask_tpu import XPySom
from xpysom_dask_tpu.models.golden import GoldenSom


def test_ring_som_1xn():
    """1×N grid (TravellingSalesmanProblem workload)."""
    rng = np.random.RandomState(4)
    cities = rng.rand(20, 2).astype(np.float32)
    som = XPySom(1, 64, 2, sigma=8, sigmaN=1, random_seed=1)
    q0 = som.quantization_error(cities)
    som.train(cities, 30)
    assert som.quantization_error(cities) < q0
    flat = som.predict(cities)
    assert flat.min() >= 0 and flat.max() < 64


def test_nx1_som():
    rng = np.random.RandomState(5)
    data = rng.rand(50, 3).astype(np.float32)
    som = XPySom(32, 1, 3, sigma=4, random_seed=2)
    som.train(data, 5)
    wx, wy = zip(*som.winner(data))
    assert all(y == 0 for y in wy)


def test_single_feature_matches_golden():
    """D=1 is maximally tie-prone: the normalized init makes every code
    value exactly ±1, so all same-sign rows tie and fp32-vs-f64 tie
    cascades diverge after the first epoch (cf. test_training_parity).
    Assert tight parity for epoch 0 and loose QE parity for the full run."""
    rng = np.random.RandomState(6)
    data = rng.rand(100, 1).astype(np.float32)
    ours = XPySom(5, 5, 1, random_seed=3)
    gold = GoldenSom(5, 5, 1, random_seed=3)
    ours.train(data, 3, iter_beg=0, iter_end=1)
    gold.train(data, 3, iter_beg=0, iter_end=1)
    np.testing.assert_allclose(ours._weights, gold.weights, rtol=1e-3, atol=1e-4)
    ours.train(data, 3, iter_beg=1, iter_end=3)
    gold.train(data, 3, iter_beg=1, iter_end=3)
    # After the tie cascade the two runs land in different (both valid)
    # configurations — observed: ours QE 0.034 vs golden 0.235. Assert
    # convergence quality rather than equality.
    assert ours.quantization_error(data) <= gold.quantization_error(data) * 1.5


def test_tiny_chunks():
    rng = np.random.RandomState(7)
    data = rng.rand(37, 4).astype(np.float32)
    som = XPySom(4, 5, 4, random_seed=4, n_parallel=8)
    som.train(data, 3)
    ref = XPySom(4, 5, 4, random_seed=4, n_parallel=64)
    ref.train(data, 3)
    np.testing.assert_allclose(som._weights, ref._weights, rtol=1e-4, atol=1e-5)


def test_nonsquare_hex_training():
    rng = np.random.RandomState(8)
    data = rng.rand(80, 3).astype(np.float32)
    ours = XPySom(4, 9, 3, topology="hexagonal", random_seed=5)
    gold = GoldenSom(4, 9, 3, topology="hexagonal", random_seed=5)
    ours.train(data, 3)
    gold.train(data, 3)
    np.testing.assert_allclose(ours._weights, gold.weights, rtol=1e-3, atol=1e-4)


def test_more_nodes_than_samples():
    rng = np.random.RandomState(9)
    data = rng.rand(5, 2).astype(np.float32)
    som = XPySom(8, 8, 2, random_seed=6)
    som.train(data, 3)  # many empty cells: den==0 keeps old weights
    assert np.isfinite(som._weights).all()


def test_chunk_alignment_keeps_results():
    """Chunk sizes above one row block align DOWN to whole kernel row
    blocks (respecting the user's n_parallel memory budget); results must
    be unchanged vs any other chunking."""
    rng = np.random.RandomState(10)
    data = rng.rand(1797, 8).astype(np.float32)  # the digits-shaped trigger
    a = XPySom(6, 6, 8, random_seed=1, n_parallel=1800)  # -> aligned to 1792
    b = XPySom(6, 6, 8, random_seed=1, n_parallel=512)
    a.train(data, 4)
    b.train(data, 4)
    np.testing.assert_allclose(a._weights, b._weights, rtol=1e-4, atol=1e-5)
    chunk = a._chunked(data)[0].shape[1]
    assert chunk % ROW_BLOCK == 0 or chunk <= ROW_BLOCK
    assert chunk <= 1800  # never exceed the caller's n_parallel budget


def test_chunk_never_exceeds_n_parallel():
    """Row-block alignment must round down: n_parallel is the (chunk, XY)
    distance-matrix memory bound inherited from the reference API."""
    data = np.random.RandomState(11).rand(4096, 4).astype(np.float32)
    for n_par in (1100, 2049, 3000, 4096):
        som = XPySom(4, 4, 4, random_seed=1, n_parallel=n_par)
        chunk = som._chunked(data)[0].shape[1]
        assert chunk <= n_par, (n_par, chunk)
        assert chunk % ROW_BLOCK == 0 or chunk <= ROW_BLOCK
