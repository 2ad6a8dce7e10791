"""End-to-end training parity: the JAX core (scatter sufficient statistics
+ factored neighborhood operator) vs the golden NumPy model that follows
the reference algorithm verbatim (materialized g, gᵀ@x GEMM). Agreement
here validates the reformulation, not just the kernels."""

import numpy as np
import pytest

from xpysom_dask_tpu import XPySom
from xpysom_dask_tpu.models.golden import GoldenSom


def _pair(x, y, d, **kw):
    seed = kw.pop("random_seed", 42)
    ours = XPySom(x, y, d, random_seed=seed, **kw)
    gold = GoldenSom(
        x,
        y,
        d,
        sigma=kw.get("sigma", 0),
        sigmaN=kw.get("sigmaN", 1),
        learning_rate=kw.get("learning_rate", 0.5),
        learning_rateN=kw.get("learning_rateN", 0.01),
        decay=kw.get("decay_function", "exponential"),
        neighborhood=kw.get("neighborhood_function", "gaussian"),
        std_coeff=kw.get("std_coeff", 0.5),
        topology=kw.get("topology", "rectangular"),
        compact_support=kw.get("compact_support", False),
        random_seed=seed,
    )
    np.testing.assert_array_equal(ours._weights, gold.weights)
    return ours, gold


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"neighborhood_function": "mexican_hat"},
        {"neighborhood_function": "bubble", "sigma": 2.0},
        {"neighborhood_function": "triangle", "sigma": 2.0},
        {"topology": "hexagonal"},
        {"topology": "hexagonal", "neighborhood_function": "mexican_hat"},
        {"topology": "hexagonal", "neighborhood_function": "bubble", "sigma": 2.0},
        # covers the per-parity-class separable hex mexican-hat operator
        # with the compact box folded into the class factors
        {
            "topology": "hexagonal",
            "neighborhood_function": "mexican_hat",
            "compact_support": True,
            "sigma": 2.0,
        },
        {"decay_function": "linear"},
        {"decay_function": "asymptotic"},
        {"compact_support": True, "sigma": 2.0},
        {"std_coeff": 1.3},
    ],
)
def test_train_matches_golden(kw):
    rng = np.random.RandomState(11)
    data = rng.rand(200, 4).astype(np.float32)
    ours, gold = _pair(6, 5, 4, **kw)
    # Piecewise-constant/-linear kernels (bubble, triangle) drive codebook
    # rows to exactly equal values; fp32 reassociation (~1e-7) then breaks
    # those argmin ties differently from the float64 oracle, so trained
    # weights diverge chaotically after a few epochs (SURVEY.md §7 risk
    # "bit-parity of argmin ties"). For those, assert tight parity over the
    # first epochs and loose QE parity over the full run.
    tie_prone = kw.get("neighborhood_function") in ("bubble", "triangle") or kw.get(
        "compact_support", False
    )
    epochs_tight = 1 if tie_prone else 5
    ours.train(data, 5, iter_beg=0, iter_end=epochs_tight)
    gold.train(data, 5, iter_beg=0, iter_end=epochs_tight)
    np.testing.assert_allclose(ours._weights, gold.weights, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        ours.quantization_error(data),
        gold.quantization_error(data),
        rtol=1e-5,
        atol=1e-6,
    )
    if tie_prone:
        ours.train(data, 5, iter_beg=epochs_tight, iter_end=5)
        gold.train(data, 5, iter_beg=epochs_tight, iter_end=5)
        np.testing.assert_allclose(
            ours.quantization_error(data),
            gold.quantization_error(data),
            rtol=5e-2,
        )


def test_train_matches_golden_multichunk():
    """Force several mini-batch chunks per epoch (n_parallel < N) — chunking
    must not change the accumulated statistics."""
    rng = np.random.RandomState(5)
    data = rng.rand(500, 3).astype(np.float32)
    ours = XPySom(5, 5, 3, random_seed=9, n_parallel=64)
    gold = GoldenSom(5, 5, 3, random_seed=9)
    ours.train(data, 3)
    gold.train(data, 3)
    np.testing.assert_allclose(ours._weights, gold.weights, rtol=1e-3, atol=1e-4)


def test_bmu_matches_golden():
    rng = np.random.RandomState(1)
    data = rng.rand(300, 6).astype(np.float32)
    ours = XPySom(7, 4, 6, random_seed=3)
    gold = GoldenSom(7, 4, 6, random_seed=3)
    got = ours.predict(data)
    want = gold.bmu(data)
    np.testing.assert_array_equal(got, want)


def test_quantization_error_parity_random_weights():
    rng = np.random.RandomState(2)
    data = rng.rand(100, 5).astype(np.float32)
    ours = XPySom(6, 6, 5, random_seed=8)
    gold = GoldenSom(6, 6, 5, random_seed=8)
    np.testing.assert_allclose(
        ours.quantization_error(data),
        gold.quantization_error(data),
        rtol=1e-5,
    )


@pytest.mark.parametrize(
    "distance,kwargs",
    [("cosine", {}), ("manhattan", {}), ("norm_p", {"p": 4})],
)
def test_training_parity_non_euclidean_activations(distance, kwargs):
    """Training under the cosine/manhattan/even-norm_p activations must
    track the float64 golden oracle — cosine is served by the fused
    kernel on the GPU (XLA path on CPU; the kernel itself is pinned in
    test_pallas.py + tests_gpu/)."""
    rng = np.random.RandomState(6)
    data = (rng.rand(1200, 10) + 0.1).astype(np.float32)

    som = XPySom(
        8,
        7,
        10,
        sigma=2.5,
        random_seed=9,
        activation_distance=distance,
        activation_distance_kwargs=kwargs,
    )
    golden = GoldenSom(
        8,
        7,
        10,
        sigma=2.5,
        random_seed=9,
        distance=distance,
        distance_kwargs=kwargs,
    )
    np.testing.assert_allclose(som._weights, golden.weights, rtol=1e-6)

    # BMU agreement under the ACTIVATION distance at IDENTICAL (initial)
    # weights — pins the BMU computation itself. (Post-training maps
    # drift chaotically through near-ties, per CLAUDE.md: compare QE.)
    bmu_s = som.predict(data)
    bmu_g = golden.bmu(data)
    assert np.mean(bmu_s == bmu_g) > 0.995, distance

    som.train(data, 6)
    golden.train(data, 6)
    # QE (always euclidean, reference semantics) against the oracle's map
    qe_s = som.quantization_error(data)
    qe_g = golden.quantization_error(data)
    # similarity-type activations have denser BMU near-ties, so f32-vs-
    # float64 drift compounds faster than the euclidean 5e-4 bound
    assert abs(qe_s - qe_g) / qe_g < 2e-3, (distance, qe_s, qe_g)


_XLA_ACTIVATIONS = [("manhattan", {})] + [
    ("norm_p", {"p": p}) for p in (1, 1.5, 2.5, 3, 4)
]


@pytest.mark.parametrize("topology", ["rectangular", "hexagonal"])
@pytest.mark.parametrize(
    "distance,kwargs", _XLA_ACTIVATIONS,
    ids=[f"{d}{k.get('p', '')}" for d, k in _XLA_ACTIVATIONS],
)
def test_xla_activation_matches_golden(distance, kwargs, topology):
    """The activations with no fused kernel take the XLA reference path
    on every backend: BMUs at the initial weights, one epoch's weights
    and the trained QE against the float64 golden model."""
    rng = np.random.RandomState(12)
    data = (rng.rand(600, 5) + 0.1).astype(np.float32)
    kw = dict(sigma=2.0, topology=topology, random_seed=4)
    som = XPySom(
        6, 6, 5, activation_distance=distance,
        activation_distance_kwargs=kwargs, **kw,
    )
    golden = GoldenSom(6, 6, 5, distance=distance, distance_kwargs=kwargs, **kw)
    assert np.mean(som.predict(data) == golden.bmu(data)) > 0.995
    som.train(data, 4, iter_end=1)
    golden.train(data, 4, iter_end=1)
    np.testing.assert_allclose(som._weights, golden.weights, rtol=1e-3, atol=1e-4)
    som.train(data, 4, iter_beg=1)
    golden.train(data, 4, iter_beg=1)
    qe_s, qe_g = som.quantization_error(data), golden.quantization_error(data)
    assert abs(qe_s - qe_g) / qe_g < 2e-3, (qe_s, qe_g)


@pytest.mark.parametrize(
    "n, cols, nodes, scale",
    [(4096, 65, 256, 1.0), (1000, 8, 10, 1e6), (64, 3, 5, 1e-20), (70000, 4, 7, 3.0)],
)
def test_scatter_sum_order_independent_and_exact(n, cols, nodes, scale):
    """The statistics' scatter: the same total whatever order the rows
    come in (bit for bit), at least as close to float64 as an f32
    scatter-add, and NaN for a column holding a non-finite value."""
    import jax
    import jax.numpy as jnp

    from xpysom_dask_tpu.core import scatter_sum

    rng = np.random.default_rng(n)
    rows = (rng.standard_normal((n, cols)) * scale).astype(np.float32)
    idx = rng.integers(0, nodes, n)
    run = jax.jit(scatter_sum, static_argnums=2)
    got = np.asarray(run(jnp.asarray(idx), jnp.asarray(rows), nodes))
    perm = rng.permutation(n)
    again = np.asarray(run(jnp.asarray(idx[perm]), jnp.asarray(rows[perm]), nodes))
    np.testing.assert_array_equal(again, got)
    ref = np.zeros((nodes, cols))
    np.add.at(ref, idx, rows.astype(np.float64))
    f32 = np.asarray(jnp.zeros((nodes, cols)).at[idx].add(rows))
    assert np.abs(got - ref).max() <= np.abs(f32 - ref).max()
    rows[0, 0] = np.inf
    bad = np.asarray(run(jnp.asarray(idx), jnp.asarray(rows), nodes))
    assert np.isnan(bad[:, 0]).all() and np.isfinite(bad[:, 1:]).all()
