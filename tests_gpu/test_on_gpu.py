"""On-card checks: the fused BMU kernel as compiled for the GPU, and the
public training path on it, against float64 NumPy references and the
golden model (reference algorithm semantics, reimplemented in
``models/golden.py``). Every test skips off the GPU (``conftest.py``).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from xpysom_dask_tpu import XPySom
from xpysom_dask_tpu.models.golden import GoldenSom
from xpysom_dask_tpu.ops.pallas import bmu as pl_bmu

pytestmark = pytest.mark.gpu

# relative float64 runner-up gap under which a winner may legitimately
# differ between two exact-to-f32 computations
NEAR_TIE = 1e-6


def _rand_problem(n=16384, xy=4096, d=64, seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(n, d).astype(np.float32), rng.rand(xy, d).astype(np.float32)


def _dist64(x, w):
    """Full squared euclidean distances in float64."""
    x, w = x.astype(np.float64), w.astype(np.float64)
    return (x**2).sum(1)[:, None] - 2 * x @ w.T + (w**2).sum(1)


def _near_tie(d64, k=1):
    """Rows whose float64 order among the k+1 nearest nodes has a
    relative gap below NEAR_TIE."""
    s = np.sort(d64, axis=1)[:, : k + 1]
    gaps = np.diff(s, axis=1) / np.maximum(s[:, 1:], 1e-30)
    return (gaps < NEAR_TIE).any(axis=1)


def test_packed_mode_exact_outside_near_ties():
    x, w = _rand_problem()
    d64 = _dist64(x, w)
    idx, val = pl_bmu.bmu_euclidean(jnp.asarray(x), jnp.asarray(w))
    wrong = (np.asarray(idx) != d64.argmin(1)) & ~_near_tie(d64)
    assert not wrong.any(), int(wrong.sum())
    partial = d64.min(1) - (x.astype(np.float64) ** 2).sum(1)
    np.testing.assert_allclose(np.asarray(val), partial, rtol=1e-4, atol=1e-3)


def test_xla_reference_exact_outside_near_ties():
    from xpysom_dask_tpu import core
    from xpysom_dask_tpu.ops.distances import DistanceFunction

    x, w = _rand_problem(seed=1)
    d64 = _dist64(x, w)
    spec = core.SomSpec(64, 64, 64, 2.0, 1.0, 0.5, 0.01, bmu_precision="highest")
    idx = core._bmu_chunk(
        DistanceFunction("euclidean"), jnp.asarray(x), jnp.asarray(w), None, spec
    )
    wrong = (np.asarray(idx) != d64.argmin(1)) & ~_near_tie(d64)
    assert not wrong.any(), int(wrong.sum())


def test_centering_recovers_offset_fidelity():
    """Offset features + smoothed (near-tied) codebook: the regime where
    the split's absolute error term bites. Centred as the library
    centres (``core.codebook_center``), the flip rate stays under 2e-3."""
    from xpysom_dask_tpu.core import codebook_center

    rng = np.random.RandomState(0)
    x = (rng.rand(16384, 64) * 4 + 8).astype(np.float32)
    w = (rng.rand(4096, 64) * 4 + 8).astype(np.float32)
    w = 0.9 * w.mean(0) + 0.1 * w
    ref = _dist64(x, w).argmin(1)
    c = codebook_center(jnp.asarray(w))
    idx, _ = pl_bmu.bmu_euclidean(jnp.asarray(x), jnp.asarray(w), center=c)
    assert float(np.mean(np.asarray(idx) != ref)) <= 2e-3


def test_bf16_mode_flip_rate_bounded():
    """The opt-in throughput mode flips near-ties only: bound the rate at
    5% and the QE gap at 1e-4 relative."""
    x, w = _rand_problem(seed=2)
    ref = _dist64(x, w).argmin(1)
    idx, _ = pl_bmu.bmu_euclidean(jnp.asarray(x), jnp.asarray(w), mode="bf16")
    idx = np.asarray(idx)
    assert float(np.mean(idx != ref)) < 0.05
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    qe_ref = np.mean(np.linalg.norm(x64 - w64[ref], axis=1))
    qe = np.mean(np.linalg.norm(x64 - w64[idx], axis=1))
    assert abs(qe - qe_ref) / qe_ref < 1e-4


def test_split2_between_packed_and_bf16():
    x, w = _rand_problem(seed=3)
    ref = _dist64(x, w).argmin(1)
    flips = {}
    for mode in ("bf16", "split2"):
        idx, _ = pl_bmu.bmu_euclidean(jnp.asarray(x), jnp.asarray(w), mode=mode)
        flips[mode] = int((np.asarray(idx) != ref).sum())
    assert flips["split2"] <= flips["bf16"], flips


def test_top2_matches_stable_argsort_and_te_fallback():
    x, w = _rand_problem(n=8192, xy=4096, d=64, seed=21)
    d64 = _dist64(x, w)
    i1, _, i2, _ = pl_bmu.bmu_euclidean(jnp.asarray(x), jnp.asarray(w), top2=True)
    ref = np.argsort(d64, axis=1, kind="stable")[:, :2]
    ok = ~_near_tie(d64, 2)
    np.testing.assert_array_equal(np.asarray(i1)[ok], ref[ok, 0])
    np.testing.assert_array_equal(np.asarray(i2)[ok], ref[ok, 1])

    rng = np.random.RandomState(22)
    data = rng.rand(4096, 16).astype(np.float32)
    som_f = XPySom(24, 24, 16, sigma=8.0, random_seed=9)
    som_f.train(data, 3)
    som_nf = XPySom(24, 24, 16, sigma=8.0, random_seed=9, use_pallas=False)
    som_nf._weights = som_f.get_weights().copy()  # same trained codebook
    te_fused = float(som_f.topographic_error(data))
    te_fallback = float(som_nf.topographic_error(data))
    assert te_fused == pytest.approx(te_fallback, abs=2e-3)


def test_cosine_kernel_matches_xla_and_trains():
    from xpysom_dask_tpu.ops.distances import DistanceFunction

    rng = np.random.RandomState(9)
    x = rng.rand(8192, 32).astype(np.float32)
    w = rng.rand(2048, 32).astype(np.float32)
    idx_c, _ = pl_bmu.bmu_cosine(jnp.asarray(x), jnp.asarray(w))
    ref_c = np.asarray(
        jnp.argmin(
            DistanceFunction("cosine").flat(jnp.asarray(x), jnp.asarray(w)), axis=1
        )
    )
    assert np.mean(np.asarray(idx_c) == ref_c) > 0.999  # near-ties only

    for dist in ("cosine", "manhattan"):
        som = XPySom(10, 10, 16, sigma=3.0, random_seed=2, activation_distance=dist)
        data = rng.rand(3000, 16).astype(np.float32)
        q0 = som.quantization_error(data)
        som.train(data, 8)
        assert som.quantization_error(data) < q0, dist


@pytest.mark.parametrize("topology", ["rectangular", "hexagonal"])
def test_train_parity_vs_golden(topology):
    """Same init, same schedule, 5 epochs on uniform data (no near-tie
    chaos): one epoch's weights within 1e-4, the run's QE within 5e-4
    relative of the float64 golden model."""
    rng = np.random.RandomState(7)
    data = rng.rand(4096, 16).astype(np.float32)
    kw = dict(sigma=3.0, topology=topology, random_seed=11)
    g1 = GoldenSom(12, 12, 16, **kw)
    s1 = XPySom(12, 12, 16, **kw)
    np.testing.assert_allclose(s1._weights, g1.weights, rtol=1e-6)
    g1.train(data, 5, iter_beg=0, iter_end=1)
    s1.train(data, 5, iter_beg=0, iter_end=1)
    np.testing.assert_allclose(s1._weights, g1.weights, rtol=1e-4, atol=1e-5)

    golden = GoldenSom(12, 12, 16, **kw)
    som = XPySom(12, 12, 16, **kw)
    golden.train(data, 5)
    som.train(data, 5)
    qe_g = golden.quantization_error(data)
    qe_s = som.quantization_error(data)
    assert abs(qe_s - qe_g) / qe_g < 5e-4, (qe_s, qe_g)


def test_population_parity_and_strategies():
    from xpysom_dask_tpu import SomPopulation

    rng = np.random.RandomState(9)
    data = rng.rand(4096, 16).astype(np.float32)
    sigmas = [2.0, 3.0, 4.0]
    pop = SomPopulation(3, 12, 12, 16, sigma=sigmas, random_seed=11)
    goldens = []
    for i in range(3):
        g = GoldenSom(12, 12, 16, sigma=sigmas[i], random_seed=11)
        g.weights = pop.member(i).get_weights().astype(np.float64).copy()
        goldens.append(g)
    pop.train(data, 5)
    qes = pop.quantization_errors(data)
    for i, g in enumerate(goldens):
        g.train(data, 5)
        qe_g = g.quantization_error(data)
        assert abs(qes[i] - qe_g) / qe_g < 5e-4, (i, qes[i], qe_g)

    kw = dict(sigma=[1.5, 2.0, 2.5], random_seed=3)
    a = SomPopulation(3, 10, 10, 16, **kw)
    a.train(data, 3, strategy="serial")
    b = SomPopulation(3, 10, 10, 16, **kw)
    b.train(data, 3, strategy="fused")
    qa = np.asarray(a.quantization_errors(data))
    qb = np.asarray(b.quantization_errors(data))
    np.testing.assert_allclose(qb, qa, rtol=0.05)


def test_no_pallas_matches_kernel_path():
    """use_pallas=False (the reference's _no_opt analog) trains to a
    codebook of the same quality as the kernel path. Trained weights can
    diverge through BMU near-ties, so compare QE and winners."""
    rng = np.random.RandomState(4)
    data = rng.rand(800, 8).astype(np.float32)
    som = XPySom(8, 8, 8, sigma=2.0, random_seed=5)
    som.train(data, 5)
    som_xla = XPySom(8, 8, 8, sigma=2.0, random_seed=5, use_pallas=False)
    som_xla.train(data, 5)
    qe_k = som.quantization_error(data)
    qe_x = som_xla.quantization_error(data)
    assert abs(qe_x - qe_k) / qe_k < 1e-3, (qe_x, qe_k)
    assert np.mean(som.predict(data) == som_xla.predict(data)) > 0.98


def test_public_api_drive():
    rng = np.random.RandomState(5)
    data = rng.rand(600, 8).astype(np.float32)
    labels = (data[:, 0] > 0.5).astype(int)

    som = XPySom(9, 7, 8, sigma=2.5, random_seed=3)
    som.pca_weights_init(data)
    som.train(data, 8)

    win = som.winner(data[:10])
    assert len(win) == 10 and all(0 <= i < 9 and 0 <= j < 7 for i, j in win)
    qe = som.quantization_error(data)
    te = som.topographic_error(data)
    assert 0 <= qe < 1.0 and 0 <= te <= 1.0
    um = som.distance_map()
    assert um.shape == (9, 7) and float(um.max()) == pytest.approx(1.0)
    ar = som.activation_response(data)
    assert ar.shape == (9, 7) and int(ar.sum()) == len(data)
    wm = som.win_map(data)
    assert sum(len(v) for v in wm.values()) == len(data)
    lm = som.labels_map(data, labels)
    assert sum(sum(c.values()) for c in lm.values()) == len(data)
    d = som.distance_from_weights(data[:64])
    assert d.shape == (64, 63)
    flat = np.asarray(d).argmin(1)
    assert [divmod(int(f), 7) for f in flat[:10]] == [
        tuple(map(int, ij)) for ij in win
    ]


def test_split_scatter_matches_fused():
    """At D=512 the separate S / cnt scatters reproduce the fused [x|1]
    scatter (``scatter_sum`` sums each column on its own, in any order)."""
    import jax

    from xpysom_dask_tpu import core

    rng = np.random.RandomState(11)
    d, xy = 512, 1024
    data = jnp.asarray(rng.rand(2, 4096, d).astype(np.float32))
    mask = jnp.asarray((rng.rand(2, 4096) > 0.05).astype(np.float32))
    w = jnp.asarray(rng.rand(xy, d).astype(np.float32))
    w_sq = jnp.sum(jnp.square(w), axis=1, keepdims=True)
    spec = core.SomSpec(32, 32, d, 4.0, 1.0, 0.5, 0.01)
    dist = spec.distance_fn()

    def run(split):
        return jax.jit(
            lambda: core._accumulate_stats(
                dist, w, w_sq, data, mask, xy, spec, split_scatter=split
            )
        )()

    (s0, c0), (s1, c1) = run(False), run(True)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s0))
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c0))


def test_streaming_matches_resident(tmp_path):
    """FileSource-streamed training, free-running over every epoch, equals
    resident training: the stream continues the resident scan's
    accumulator and the statistics' sums do not depend on the order of
    the card's atomic adds. Also over several superbatches an epoch."""
    from xpysom_dask_tpu.parallel.pipeline import FileSource, train_streaming

    rng = np.random.RandomState(17)
    n, d = 4096, 16
    data = rng.rand(n, d).astype(np.float32)
    path = tmp_path / "stream.f32"
    data.tofile(path)
    kw = dict(sigma=3.0, random_seed=5, n_parallel=1024)
    resident = XPySom(8, 8, d, **kw)
    resident.train(data, 3)
    streamed = XPySom(8, 8, d, **kw)
    streamed.train(FileSource(str(path), n, d), 3)
    np.testing.assert_allclose(
        streamed.get_weights(), resident.get_weights(), rtol=1e-5, atol=1e-6
    )
    w = train_streaming(
        resident._spec, XPySom(8, 8, d, **kw).get_weights(),
        FileSource(str(path), n, d), 3, chunk=1024, superbatch_rows=1024,
    )
    np.testing.assert_allclose(w, resident.get_weights(), rtol=1e-5, atol=1e-6)


def test_streaming_chunk_alignment_and_repeat():
    """An unaligned explicit n_parallel (1800) is cut to whole row blocks
    (1792 rows) on both paths, so streamed and resident training sum the
    same chunks in the same order and agree to the bit; a repeated run
    does too."""
    from xpysom_dask_tpu.parallel.pipeline import ArraySource

    rng = np.random.RandomState(11)
    data = np.concatenate(
        [c + 0.25 * rng.randn(600, 16) for c in rng.rand(4, 16) * 4]
    ).astype(np.float32)
    kw = dict(sigma=2.5, random_seed=7, n_parallel=1800)
    runs = []
    for source in (ArraySource(data), data, data):
        som = XPySom(8, 8, 16, **kw)
        som.train(source, 4)
        runs.append(som.get_weights())
    np.testing.assert_array_equal(runs[0], runs[1])
    np.testing.assert_array_equal(runs[2], runs[1])


@pytest.mark.parametrize("d", sorted(pl_bmu._BLOCKS))
def test_kernel_compiles_at_every_table_width(d):
    """Every row of the block table compiles (within the card's shared
    memory) and matches float64 outside near-ties."""
    x, w = _rand_problem(n=2048, xy=2048, d=d, seed=d)
    d64 = _dist64(x, w)
    for top2 in (False, True):
        outs = pl_bmu.bmu_euclidean(jnp.asarray(x), jnp.asarray(w), top2=top2)
        wrong = (np.asarray(outs[0]) != d64.argmin(1)) & ~_near_tie(d64)
        assert not wrong.any(), (d, top2, int(wrong.sum()))


def test_scale_512_smoke():
    """The largest supported map (512×512×64) compiles and trains through
    the public API with finite, learning weights."""
    rng = np.random.RandomState(11)
    data = rng.rand(8192, 64).astype(np.float32)
    som = XPySom(512, 512, 64, sigma=256.0, random_seed=7)
    qe_before = float(som.quantization_error(data[:2048]))
    som.train(data, 2)
    w = som.get_weights()
    assert w.shape == (512, 512, 64) and np.isfinite(w).all()
    assert float(som.quantization_error(data[:2048])) < qe_before


@pytest.mark.parametrize("mesh_kind", ["auto", "grid11"])
def test_mesh_paths_match_single_device(mesh_kind):
    """The kernels inside shard_map: a 1-D data mesh and a degenerate
    (data=1, model=1) grid mesh trace the sharded programs (collectives,
    shard-invariant centring, top-2 merge) on one card and must match the
    unsharded path."""
    from xpysom_dask_tpu.parallel.grid_sharded import make_grid_mesh

    rng = np.random.RandomState(33)
    data = rng.rand(4096, 16).astype(np.float32)
    mesh = "auto" if mesh_kind == "auto" else make_grid_mesh(1, 1)
    som_s = XPySom(12, 10, 16, sigma=4.0, random_seed=4)
    som_s.train(data, 4)
    som_m = XPySom(12, 10, 16, sigma=4.0, random_seed=4, mesh=mesh)
    som_m.train(data, 4)
    np.testing.assert_allclose(
        som_m.get_weights(), som_s.get_weights(), rtol=1e-4, atol=1e-5
    )
    assert som_m.quantization_error(data) == pytest.approx(
        som_s.quantization_error(data), rel=1e-5
    )
    assert som_m.topographic_error(data) == pytest.approx(
        som_s.topographic_error(data), abs=2e-3
    )


def test_norm_p_rides_xla_path():
    """Non-euclidean/cosine activations take the XLA reference path on the
    card, including zero and negative p; training reduces QE."""
    from xpysom_dask_tpu.core import _pallas_bmu_kind
    from xpysom_dask_tpu.ops.distances import DistanceFunction

    for p in (3, 4, 2.5, 0, -2):
        assert _pallas_bmu_kind(DistanceFunction("norm_p", {"p": p}), 16) is None
    assert _pallas_bmu_kind(DistanceFunction("euclidean"), 16) == "euclidean"
    rng = np.random.RandomState(68)
    data = np.concatenate(
        [c + 0.2 * rng.randn(256, 8) for c in rng.rand(3, 8) * 4]
    ).astype(np.float32)
    for p in (3, 1.5, -2):
        som = XPySom(
            8, 8, 8, sigma=2.0, random_seed=9,
            activation_distance="norm_p", activation_distance_kwargs={"p": p},
        )
        qe0 = float(som.quantization_error(data))
        som.train(data, 4)
        assert float(som.quantization_error(data)) < qe0, p
