"""SomPopulation: P-member batched training vs serial XPySom parity.

The population path reformulates per-member training as one concatenated-
codebook program (models/population.py); these tests pin that the batched
program computes the SAME math as P serial single-model trains, that
per-member hyperparameters actually flow, and that the data-parallel mesh
variant matches the single-device one.

Comparison discipline (CLAUDE.md / MIGRATION.md): trained weights are
compared across programs only at ONE epoch. The concatenated (chunk, P·XY)
GEMM rounds last-ulp differently from the serial (chunk, XY) GEMM (measured
Δd ≈ 6e-5 at |d| ~ O(1)), and after an epoch the neighborhood-collapsed
codebook has BMU margins at/below f32 resolution (exact 0.0 ties measured)
— so multi-epoch trajectories separate chaotically between ANY two
formulations of the same math. Multi-epoch parity is therefore pinned on
quantization error, the project's cross-implementation metric.
"""

import numpy as np
import pytest
from jax.sharding import Mesh
import jax

from xpysom_dask_tpu import SomPopulation, XPySom


def _blobs(n=240, d=8, seed=3):
    rng = np.random.RandomState(seed)
    return rng.rand(n, d).astype(np.float32)


def test_population_one_epoch_matches_serial_bitwise_class():
    """After ONE epoch (pre-collapse: no BMU near-ties) every member matches
    its serial twin to fp-noise."""
    data = _blobs()
    sigmas = [1.0, 2.0, 3.0]
    lrs = [0.5, 0.3, 0.7]
    pop = SomPopulation(
        3, 6, 5, 8, sigma=sigmas, learning_rate=lrs, random_seed=11
    )
    pop.train(data, 3, iter_beg=0, iter_end=1, strategy="batched")
    for i in range(3):
        ref = XPySom(
            6, 5, 8, sigma=sigmas[i], learning_rate=lrs[i], random_seed=11 + i
        )
        ref.train(data, 3, iter_beg=0, iter_end=1)
        np.testing.assert_allclose(
            pop.member(i).get_weights(), ref.get_weights(), rtol=1e-6, atol=1e-7
        )


def test_population_multi_epoch_qe_matches_serial():
    data = _blobs()
    sigmas = [1.0, 2.0, 3.0]
    pop = SomPopulation(3, 6, 5, 8, sigma=sigmas, random_seed=11)
    pop.train(data, 4, strategy="batched")
    for i in range(3):
        ref = XPySom(6, 5, 8, sigma=sigmas[i], random_seed=11 + i)
        ref.train(data, 4)
        assert pop.member(i).quantization_error(data) == pytest.approx(
            ref.quantization_error(data), rel=0.05
        )


def test_population_quantization_errors_empty_returns_nan():
    """Empty-input contract matches XPySom.quantization_error: warn and
    return NaN, not raise (advisor, round 3)."""
    pop = SomPopulation(3, 4, 4, 8, sigma=1.0, random_seed=0)
    with pytest.warns(UserWarning, match="empty"):
        qes = pop.quantization_errors(np.zeros((0, 8), np.float32))
    assert qes.shape == (3,)
    assert np.isnan(qes).all()


def test_population_quantization_errors_match_members():
    data = _blobs(n=180)
    pop = SomPopulation(3, 5, 5, 8, sigma=[1.0, 1.5, 2.0], random_seed=4)
    pop.train(data, 2)
    qes = pop.quantization_errors(data)
    assert qes.shape == (3,)
    for i in range(3):
        assert qes[i] == pytest.approx(
            pop.member(i).quantization_error(data), rel=1e-4
        )


def test_best_returns_lowest_qe_member():
    data = _blobs(n=200)
    # wildly different learning rates → members genuinely differ
    pop = SomPopulation(
        3, 5, 5, 8, learning_rate=[0.9, 0.5, 0.01], random_seed=7
    )
    pop.train(data, 3)
    qes = pop.quantization_errors(data)
    best = pop.best(data)
    assert best is pop.member(int(np.argmin(qes)))
    # and it is a working XPySom
    assert best.predict(data[:5]).shape == (5,)
    assert best.quantization(data[:5]).shape == (5, 8)


def test_per_member_hyperparams_flow():
    """Same seed, different sigma → different trained codebooks."""
    data = _blobs(n=160)
    pop = SomPopulation(2, 6, 6, 8, sigma=[0.5, 3.0], random_seed=[5, 5])
    w0_init = pop.member(0).get_weights().copy()
    np.testing.assert_allclose(w0_init, pop.member(1).get_weights())
    pop.train(data, 2)
    assert not np.allclose(
        pop.member(0).get_weights(), pop.member(1).get_weights()
    )


def test_seed_broadcast_and_validation():
    pop = SomPopulation(3, 4, 4, 6, random_seed=9)
    # int seed → member i seeded with seed+i: inits all differ
    w = pop.weights
    assert w.shape == (3, 4, 4, 6)
    assert not np.allclose(w[0], w[1]) and not np.allclose(w[1], w[2])

    with pytest.raises(ValueError, match="length-3"):
        SomPopulation(3, 4, 4, 6, sigma=[1.0, 2.0])
    with pytest.raises(ValueError, match="n_members"):
        SomPopulation(0, 4, 4, 6)
    with pytest.raises(ValueError):
        SomPopulation(2, 4, 4, 6, neighborhood_function="nope")


def test_population_mesh_matches_single_device():
    data = _blobs(n=300)
    kw = dict(sigma=[1.0, 2.0], learning_rate=[0.4, 0.6], random_seed=2)
    pop1 = SomPopulation(2, 5, 4, 8, **kw)
    pop1.train(data, 2, iter_beg=0, iter_end=1, strategy="batched")

    devs = np.array(jax.devices()[:4])
    mesh = Mesh(devs, axis_names=("data",))
    pop2 = SomPopulation(2, 5, 4, 8, mesh=mesh, **kw)
    pop2.train(data, 2, iter_beg=0, iter_end=1, strategy="batched")

    # one epoch: weights parity across the psum/single-device programs
    np.testing.assert_allclose(pop1.weights, pop2.weights, rtol=1e-5, atol=1e-6)

    # full run: QE parity (multi-epoch weights are chaos-sensitive)
    pop1.train(data, 2, iter_beg=1, iter_end=2, strategy="batched")
    pop2.train(data, 2, iter_beg=1, iter_end=2, strategy="batched")
    np.testing.assert_allclose(
        pop1.quantization_errors(data),
        pop2.quantization_errors(data),
        rtol=0.05,
    )


def test_population_grid_mesh_rejected():
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, axis_names=("data", "model"))
    with pytest.raises(ValueError, match="data-parallel"):
        SomPopulation(2, 4, 4, 6, mesh=mesh)


@pytest.mark.parametrize(
    "kw",
    [
        dict(topology="hexagonal"),
        dict(neighborhood_function="mexican_hat"),
        dict(decay_function="linear"),
        dict(activation_distance="cosine"),
        dict(activation_distance="manhattan"),
        dict(neighborhood_function="bubble", compact_support=True),
    ],
    ids=["hex", "mexican_hat", "linear", "cosine", "manhattan", "bubble"],
)
def test_population_one_epoch_parity_nondefault(kw):
    """Non-default configs ride the same population program: one-epoch
    weights match the serial twin to fp-noise."""
    data = _blobs(n=150)
    pop = SomPopulation(2, 5, 5, 8, sigma=[1.0, 2.0], random_seed=13, **kw)
    pop.train(data, 2, iter_beg=0, iter_end=1, strategy="batched")
    for i in range(2):
        ref = XPySom(
            5, 5, 8, sigma=[1.0, 2.0][i], random_seed=13 + i, **kw
        )
        ref.train(data, 2, iter_beg=0, iter_end=1)
        np.testing.assert_allclose(
            pop.member(i).get_weights(), ref.get_weights(), rtol=1e-5, atol=1e-6
        )


def test_population_verbose_epoch_path(capsys):
    data = _blobs(n=120)
    pop = SomPopulation(2, 4, 4, 8, random_seed=1)
    pop.train(data, 2, verbose=True)
    out = capsys.readouterr().out
    assert "quantization errors" in out


def test_population_iter_segments_compose():
    """Segmented training [0,1)+[1,3) equals one [0,3) run (same program —
    bitwise-stable, no cross-program chaos)."""
    data = _blobs(n=140)
    kw = dict(sigma=[1.0, 2.0], random_seed=6)
    pop_a = SomPopulation(2, 5, 5, 8, **kw)
    pop_a.train(data, 3)
    pop_b = SomPopulation(2, 5, 5, 8, **kw)
    pop_b.train(data, 3, iter_beg=0, iter_end=1)
    pop_b.train(data, 3, iter_beg=1, iter_end=3)
    np.testing.assert_allclose(pop_a.weights, pop_b.weights, rtol=1e-5)


def test_population_pickle_roundtrip():
    """Pickling drops device handles; trained state survives the trip."""
    import pickle

    data = _blobs(n=120)
    pop = SomPopulation(2, 4, 4, 8, sigma=[1.0, 2.0], random_seed=8)
    pop.train(data, 2)
    clone = pickle.loads(pickle.dumps(pop))
    np.testing.assert_allclose(clone.weights, pop.weights)
    np.testing.assert_allclose(
        clone.quantization_errors(data), pop.quantization_errors(data), rtol=1e-6
    )


def test_member_init_flows_into_population_training():
    """Codebook init applied to a member (pca/random/custom) is the state
    population training starts from — weights are read from members at
    each train call."""
    data = _blobs(n=160)
    pop = SomPopulation(2, 5, 5, 8, sigma=[1.0, 2.0], random_seed=3)
    pop.member(0).pca_weights_init(data)
    w_init = pop.weights.copy()
    pop.train(data, 3, iter_beg=0, iter_end=0)  # zero epochs: passthrough
    np.testing.assert_allclose(pop.weights, w_init, rtol=1e-6)

    # and a real train from pca init matches the serial twin at one epoch
    pop.train(data, 2, iter_beg=0, iter_end=1, strategy="batched")
    ref = XPySom(5, 5, 8, sigma=1.0, random_seed=3)
    ref.pca_weights_init(data)
    ref.train(data, 2, iter_beg=0, iter_end=1)
    np.testing.assert_allclose(
        pop.member(0).get_weights(), ref.get_weights(), rtol=1e-5, atol=1e-6
    )


def test_population_single_member_degenerate():
    """P=1 is just a slower XPySom — exact one-epoch parity."""
    data = _blobs(n=100)
    pop = SomPopulation(1, 5, 5, 8, sigma=1.5, random_seed=21)
    pop.train(data, 2, iter_beg=0, iter_end=1, strategy="batched")
    ref = XPySom(5, 5, 8, sigma=1.5, random_seed=21)
    ref.train(data, 2, iter_beg=0, iter_end=1)
    np.testing.assert_allclose(
        pop.member(0).get_weights(), ref.get_weights(), rtol=1e-6, atol=1e-7
    )


def test_population_periodic_checkpointing(tmp_path):
    """checkpoint_every on a population sweep writes resumable
    checkpoints and ends at the same weights as an uninterrupted sweep
    (VERDICT r3 #8 — fault tolerance for long model-selection runs),
    mirroring test_pipeline_serialization.test_periodic_checkpointing."""
    data = _blobs(n=160)
    ckpt = tmp_path / "pop_periodic.npz"

    full = SomPopulation(3, 5, 5, 8, sigma=[1.0, 1.5, 2.0], random_seed=11)
    full.train(data, 6)

    ck = SomPopulation(3, 5, 5, 8, sigma=[1.0, 1.5, 2.0], random_seed=11)
    ck.train(data, 6, checkpoint_path=ckpt, checkpoint_every=2)
    np.testing.assert_allclose(ck.weights, full.weights, rtol=1e-5, atol=1e-6)

    # simulate failure recovery from the last checkpoint
    loaded = SomPopulation.load_checkpoint(ckpt)
    assert loaded._checkpoint_epoch == 6
    assert loaded.n_members == 3
    np.testing.assert_array_equal(loaded.weights, ck.weights)
    # per-member schedules survived the round-trip
    assert [m._sigma for m in loaded.members] == [1.0, 1.5, 2.0]


def test_population_checkpoint_resume_matches_uninterrupted(tmp_path):
    """Kill-and-resume: train 6 epochs in one go vs train 3, reload from
    the checkpoint, train epochs [3, 6) — identical codebooks and intact
    per-member RNG streams."""
    data = _blobs(n=160)
    ckpt = tmp_path / "pop_resume.npz"

    full = SomPopulation(2, 5, 5, 8, sigma=[1.0, 2.0], random_seed=5)
    full.train(data, 6)

    part = SomPopulation(2, 5, 5, 8, sigma=[1.0, 2.0], random_seed=5)
    part.train(data, 6, iter_beg=0, iter_end=3)
    part.save_checkpoint(ckpt, epoch=3)
    resumed = SomPopulation.load_checkpoint(ckpt)
    resumed.train(data, 6, iter_beg=resumed._checkpoint_epoch)
    np.testing.assert_allclose(
        resumed.weights, full.weights, rtol=1e-5, atol=1e-6
    )
    # RNG streams travel with the checkpoint (exact resume contract)
    for a, b in zip(resumed.members, part.members):
        np.testing.assert_array_equal(
            a._random_generator.rand(4), b._random_generator.rand(4)
        )


def test_population_checkpoint_verbose_path(tmp_path, capsys):
    """The per-epoch (verbose) path checkpoints too."""
    data = _blobs(n=120)
    ckpt = tmp_path / "pop_verbose.npz"
    pop = SomPopulation(2, 4, 4, 8, sigma=1.0, random_seed=2)
    pop.train(data, 3, verbose=True, checkpoint_path=ckpt, checkpoint_every=1)
    capsys.readouterr()
    loaded = SomPopulation.load_checkpoint(ckpt)
    assert loaded._checkpoint_epoch == 3
    np.testing.assert_array_equal(loaded.weights, pop.weights)


def test_population_checkpoint_rejects_single_model_file(tmp_path):
    som = XPySom(4, 4, 8, random_seed=1)
    p = tmp_path / "single.npz"
    som.save_checkpoint(p)
    with pytest.raises(ValueError, match="single-model"):
        SomPopulation.load_checkpoint(p)
    pop = SomPopulation(2, 4, 4, 8, random_seed=1)
    pop.save_checkpoint(tmp_path / "pop.npz")
    with pytest.raises((ValueError, KeyError)):
        XPySom.load_checkpoint(tmp_path / "pop.npz")


def test_population_streaming_matches_resident(tmp_path):
    """Source-like data streams through the population path: streamed
    sweep == resident sweep (same stats-fold + update math; mirrors the
    single-model streaming parity in test_pipeline_serialization)."""
    from xpysom_dask_tpu.parallel.pipeline import ArraySource, IterableSource

    data = _blobs(n=400)
    kw = dict(sigma=[1.0, 2.0], random_seed=9)
    resident = SomPopulation(2, 5, 5, 8, **kw)
    resident.train(data, 3)

    streamed = SomPopulation(2, 5, 5, 8, **kw)
    streamed.train(ArraySource(data), 3)
    np.testing.assert_allclose(
        streamed.weights, resident.weights, rtol=1e-4, atol=1e-5
    )

    # memmap duck-typing + ragged producer blocks
    mm_path = tmp_path / "pop.f32"
    data.tofile(mm_path)
    mm = np.memmap(mm_path, dtype=np.float32, mode="r", shape=(400, 8))
    streamed2 = SomPopulation(2, 5, 5, 8, **kw)
    streamed2.train(mm, 3)
    np.testing.assert_allclose(
        streamed2.weights, resident.weights, rtol=1e-4, atol=1e-5
    )

    def factory():
        for start in range(0, 400, 77):
            yield data[start : start + 77]

    streamed3 = SomPopulation(2, 5, 5, 8, **kw)
    streamed3.train(IterableSource(factory, 400, 8), 3)
    np.testing.assert_allclose(
        streamed3.weights, resident.weights, rtol=1e-4, atol=1e-5
    )


def test_population_streaming_checkpoint_and_validation(tmp_path):
    from xpysom_dask_tpu.parallel.pipeline import ArraySource

    data = _blobs(n=200)
    ckpt = tmp_path / "pop_stream.npz"
    pop = SomPopulation(2, 4, 4, 8, random_seed=3)
    pop.train(
        ArraySource(data), 4, checkpoint_path=ckpt, checkpoint_every=2
    )
    loaded = SomPopulation.load_checkpoint(ckpt)
    assert loaded._checkpoint_epoch == 4
    np.testing.assert_array_equal(loaded.weights, pop.weights)

    with pytest.raises(ValueError, match="features"):
        SomPopulation(2, 4, 4, 6, random_seed=3).train(ArraySource(data), 1)
    with pytest.raises(ValueError, match="empty"):
        SomPopulation(2, 4, 4, 8, random_seed=3).train(
            ArraySource(np.zeros((0, 8), np.float32)), 1
        )


def test_population_checkpoint_preserves_member_kernel_config(
    tmp_path, monkeypatch
):
    """Code-review r4: a resumed sweep must run the SAME argmin kernel
    the earlier epochs ran — bmu_precision travels with the population
    checkpoint even when it was env-sourced and the loading host's env
    differs."""
    monkeypatch.setenv("XPYSOM_BMU_PRECISION", "highest")
    pop = SomPopulation(2, 4, 4, 8, random_seed=3)
    assert all(m._bmu_precision == "highest" for m in pop.members)
    p = tmp_path / "pop_cfg.npz"
    pop.save_checkpoint(p, epoch=1)
    monkeypatch.delenv("XPYSOM_BMU_PRECISION")
    loaded = SomPopulation.load_checkpoint(p)
    assert all(m._bmu_precision == "highest" for m in loaded.members)
    # specs reflect it (the compiled programs key on this)
    assert all(s.bmu_precision == "highest" for s in loaded._specs())


def test_population_best_empty_raises():
    pop = SomPopulation(2, 4, 4, 8, random_seed=0)
    with pytest.warns(UserWarning, match="empty"):
        with pytest.raises(ValueError, match="empty"):
            pop.best(np.zeros((0, 8), np.float32))


def test_population_quantization_errors_streams_sources(tmp_path):
    """quantization_errors/best accept the same source-like inputs as
    train (review r4: the out-of-core sweep workflow must compose with
    model selection); streamed == resident, feature validation raises
    the reference-style error."""
    from xpysom_dask_tpu.parallel.pipeline import ArraySource, FileSource

    data = _blobs(n=300)
    pop = SomPopulation(3, 5, 5, 8, sigma=[1.0, 1.5, 2.0], random_seed=4)
    pop.train(data, 2)
    resident = pop.quantization_errors(data)
    np.testing.assert_allclose(
        pop.quantization_errors(ArraySource(data)), resident, rtol=1e-6
    )
    p = tmp_path / "pop_qe.f32"
    data.tofile(p)
    np.testing.assert_allclose(
        pop.quantization_errors(FileSource(str(p), 300, 8)), resident,
        rtol=1e-6,
    )
    mm = np.memmap(p, dtype=np.float32, mode="r", shape=(300, 8))
    np.testing.assert_allclose(
        pop.quantization_errors(mm), resident, rtol=1e-6
    )
    best = pop.best(ArraySource(data))
    assert best is pop.member(int(np.argmin(resident)))
    with pytest.raises(ValueError, match="features"):
        pop.quantization_errors(np.zeros((10, 5), np.float32))
    with pytest.raises(ValueError, match="features"):
        pop.quantization_errors(ArraySource(np.zeros((10, 5), np.float32)))


def test_population_train_rejects_negative_checkpoint_every(tmp_path):
    pop = SomPopulation(2, 4, 4, 8, random_seed=1)
    with pytest.raises(ValueError, match="checkpoint_every"):
        pop.train(_blobs(n=50), 2, checkpoint_path=tmp_path / "x",
                  checkpoint_every=-2)
    with pytest.raises(ValueError, match="checkpoint_every"):
        XPySom(4, 4, 8).train(_blobs(n=50), 2,
                              checkpoint_path=tmp_path / "y",
                              checkpoint_every=-1)


def test_population_empty_verbose_does_not_crash(capsys):
    """Empty resident data with verbose=True: no ZeroDivisionError from
    the progress bar (review r4); warns NaN QE like the quiet path."""
    pop = SomPopulation(2, 4, 4, 8, random_seed=1)
    with pytest.warns(UserWarning, match="empty"):
        pop.train(np.zeros((0, 8), np.float32), 2, verbose=True)
    capsys.readouterr()


def test_population_streaming_verbose_prints_qe(capsys):
    from xpysom_dask_tpu.parallel.pipeline import ArraySource

    data = _blobs(n=120)
    pop = SomPopulation(2, 4, 4, 8, random_seed=1)
    pop.train(ArraySource(data), 2, verbose=True)
    assert "quantization errors" in capsys.readouterr().out

# -- strategy routing ('auto' routes resident data per member) ----------


def test_population_serial_bitwise_matches_individual_training():
    """strategy='serial' (the 'auto' default for resident data) runs each
    member through the SAME compiled program as XPySom.train with the same
    chunking -> bit-identical weights, no fp-noise tolerance needed.
    The reference model is a PLAIN standalone XPySom (no n_parallel
    pinning): auto-sized members self-size exactly like one, so serial
    sweeps ride the single-model fast path's own chunk budget instead of
    the concatenated-matrix one (round-5 review finding)."""
    data = _blobs(n=220)
    sigmas = [1.0, 2.0, 3.0]
    lrs = [0.5, 0.3, 0.7]
    pop = SomPopulation(
        3, 6, 5, 8, sigma=sigmas, learning_rate=lrs, random_seed=11
    )
    pop.train(data, 3, strategy="serial")
    for i in range(3):
        ref = XPySom(
            6, 5, 8, sigma=sigmas[i], learning_rate=lrs[i],
            random_seed=11 + i,
        )
        ref.train(data, 3)
        np.testing.assert_array_equal(
            pop.member(i).get_weights(), ref.get_weights()
        )
    # auto members carry the standalone auto budget, not the concat one
    assert pop.member(0)._n_parallel == XPySom(6, 5, 8)._n_parallel


def test_population_explicit_n_parallel_reaches_members_and_serial():
    """An explicit n_parallel is the user's memory bound (reference
    xpysom.py:131-137): members carry it verbatim and the serial sweep
    stays bit-identical to individual training at that bound."""
    data = _blobs(n=220)
    pop = SomPopulation(2, 6, 5, 8, random_seed=3, n_parallel=64)
    assert pop.member(0)._n_parallel == 64
    assert pop.member(0)._n_parallel_explicit
    pop.train(data, 2, strategy="serial")
    for i in range(2):
        ref = XPySom(6, 5, 8, random_seed=3 + i, n_parallel=64)
        ref.train(data, 2)
        np.testing.assert_array_equal(
            pop.member(i).get_weights(), ref.get_weights()
        )


def test_population_auto_is_serial_for_resident_data():
    data = _blobs(n=150)
    a = SomPopulation(2, 5, 5, 8, sigma=[1.0, 2.0], random_seed=4)
    a.train(data, 2)  # auto
    b = SomPopulation(2, 5, 5, 8, sigma=[1.0, 2.0], random_seed=4)
    b.train(data, 2, strategy="serial")
    np.testing.assert_array_equal(a.weights, b.weights)


def test_population_serial_vs_batched_qe_parity():
    """Same math, different programs: compare by QE (MIGRATION delta 7)."""
    data = _blobs(n=240)
    a = SomPopulation(3, 6, 5, 8, sigma=[1.0, 1.5, 2.0], random_seed=9)
    a.train(data, 4, strategy="serial")
    b = SomPopulation(3, 6, 5, 8, sigma=[1.0, 1.5, 2.0], random_seed=9)
    b.train(data, 4, strategy="batched")
    np.testing.assert_allclose(
        a.quantization_errors(data), b.quantization_errors(data), rtol=0.05
    )


def test_population_strategy_validation():
    data = _blobs(n=64)
    pop = SomPopulation(2, 4, 4, 8, random_seed=1)
    with pytest.raises(ValueError, match="strategy"):
        pop.train(data, 1, strategy="fastest")
    # streaming sources cannot train serially (single pass serves all)
    mm_path = None
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        mm_path = os.path.join(d, "x.dat")
        mm = np.memmap(mm_path, dtype=np.float32, mode="w+", shape=(64, 8))
        mm[:] = data[:64]
        mm.flush()
        with pytest.raises(ValueError, match="serial"):
            pop.train(mm, 1, strategy="serial")
        # auto on a source routes batched and works
        pop.train(mm, 1)


def test_population_serial_mesh_matches_single_device():
    data = _blobs(n=300)
    kw = dict(sigma=[1.0, 2.0], learning_rate=[0.4, 0.6], random_seed=2)
    pop1 = SomPopulation(2, 5, 4, 8, **kw)
    pop1.train(data, 2, iter_beg=0, iter_end=1, strategy="serial")

    devs = np.array(jax.devices()[:4])
    mesh = Mesh(devs, axis_names=("data",))
    pop2 = SomPopulation(2, 5, 4, 8, mesh=mesh, **kw)
    pop2.train(data, 2, iter_beg=0, iter_end=1, strategy="serial")
    np.testing.assert_allclose(pop1.weights, pop2.weights, rtol=1e-5, atol=1e-6)


def test_population_serial_checkpoint_resume(tmp_path):
    """Serial-strategy sweeps checkpoint/resume exactly, and a resume may
    switch strategies (checkpoints are strategy-agnostic)."""
    data = _blobs(n=160)
    ckpt = tmp_path / "pop_serial.npz"

    full = SomPopulation(2, 5, 5, 8, sigma=[1.0, 2.0], random_seed=5)
    full.train(data, 6, strategy="serial")

    ck = SomPopulation(2, 5, 5, 8, sigma=[1.0, 2.0], random_seed=5)
    ck.train(
        data, 6, strategy="serial", checkpoint_path=ckpt, checkpoint_every=3
    )
    np.testing.assert_array_equal(ck.weights, full.weights)

    resumed = SomPopulation.load_checkpoint(ckpt)
    assert resumed._checkpoint_epoch == 6
    np.testing.assert_array_equal(resumed.weights, full.weights)


def test_population_serial_verbose_path(capsys):
    data = _blobs(n=120)
    pop = SomPopulation(2, 4, 4, 8, random_seed=1)
    pop.train(data, 2, verbose=True, strategy="serial")
    out = capsys.readouterr().out
    assert "quantization errors" in out


def test_population_fused_matches_serial_one_epoch():
    """Round 5: the 'fused' strategy (lax.map over members, fused
    single-model stats body) computes the SAME math as 'serial' — on the
    CPU both reduce to dist.flat + argmin per member, so one epoch matches
    bitwise-class tight; multi-epoch compares by QE (module header)."""
    data = _blobs(n=220)
    a = SomPopulation(3, 5, 5, 8, sigma=[1.0, 1.5, 2.0], random_seed=7)
    a.train(data, 1, strategy="serial")
    b = SomPopulation(3, 5, 5, 8, sigma=[1.0, 1.5, 2.0], random_seed=7)
    b.train(data, 1, strategy="fused")
    np.testing.assert_allclose(a.weights, b.weights, rtol=1e-5, atol=1e-6)

    a.train(data, 4, strategy="serial")
    b.train(data, 4, strategy="fused")
    np.testing.assert_allclose(
        a.quantization_errors(data), b.quantization_errors(data), rtol=0.05
    )


def test_population_streaming_fused_and_batched_parity(tmp_path):
    """Streaming strategy surface (round 5): 'auto' rides the fused
    one-pass program; explicit 'fused' matches it bitwise; 'batched'
    stays available and matches the same resident sweep."""
    from xpysom_dask_tpu.parallel.pipeline import ArraySource

    data = _blobs(n=300)
    kw = dict(sigma=[1.0, 2.0], random_seed=11)

    auto = SomPopulation(2, 5, 5, 8, **kw)
    auto.train(ArraySource(data), 3)
    fused = SomPopulation(2, 5, 5, 8, **kw)
    fused.train(ArraySource(data), 3, strategy="fused")
    np.testing.assert_array_equal(auto.weights, fused.weights)

    resident = SomPopulation(2, 5, 5, 8, **kw)
    resident.train(data, 3, strategy="fused")
    np.testing.assert_allclose(
        fused.weights, resident.weights, rtol=1e-4, atol=1e-5
    )

    batched = SomPopulation(2, 5, 5, 8, **kw)
    batched.train(ArraySource(data), 3, strategy="batched")
    np.testing.assert_allclose(
        np.asarray(batched.quantization_errors(data)),
        np.asarray(fused.quantization_errors(data)),
        rtol=0.05,
    )


def test_population_streaming_auto_gate_routes_measured_rows():
    """The streaming-'auto' gate: stacked codebooks up to 32,768 nodes
    (P of 24×24 maps, P ≤ 56) route to 'fused', larger ones to 'concat'.
    The crossover was measured on another accelerator; the GPU's is not
    measured yet (ROADMAP)."""
    from xpysom_dask_tpu.models.population import _streaming_auto_impl

    # fused-side rows: P ∈ {4, 16, 32, 40, 48, 56} of 24×24 maps
    for p in (4, 16, 32, 40, 48, 56):
        assert _streaming_auto_impl(p * 24 * 24) == "fused"
    # batched-side row: P=64 (36,864 nodes, batched measured 1.19× faster)
    assert _streaming_auto_impl(64 * 24 * 24) == "concat"


def test_population_fused_mesh_matches_single_device():
    """'fused' under a data mesh: shard_map + psum over the lax.map
    program equals the unsharded one."""
    devs = np.array(jax.devices()[:4])
    mesh = Mesh(devs, ("data",))
    data = _blobs(n=256)
    kw = dict(sigma=[1.0, 2.0], random_seed=6)
    un = SomPopulation(2, 5, 5, 8, **kw)
    un.train(data, 2, strategy="fused")
    sh = SomPopulation(2, 5, 5, 8, mesh=mesh, **kw)
    sh.train(data, 2, strategy="fused")
    np.testing.assert_allclose(sh.weights, un.weights, rtol=1e-4, atol=1e-5)


def test_population_checkpoint_resume_switches_strategies(tmp_path):
    """ADVICE r4 #3: actually RESUME from a checkpoint under the other
    strategy (both directions) and pin QE parity with an uninterrupted
    run — the 'checkpoints are strategy-agnostic' contract, exercised."""
    data = _blobs(n=200)
    full = SomPopulation(2, 5, 5, 8, sigma=[1.0, 2.0], random_seed=5)
    full.train(data, 6, strategy="serial")
    qe_full = np.asarray(full.quantization_errors(data))

    for first, second in (("serial", "batched"), ("batched", "serial"),
                          ("fused", "serial")):
        ckpt = tmp_path / f"switch_{first}_{second}.npz"
        a = SomPopulation(2, 5, 5, 8, sigma=[1.0, 2.0], random_seed=5)
        a.train(data, 6, iter_end=3, strategy=first,
                checkpoint_path=ckpt, checkpoint_every=3)
        b = SomPopulation.load_checkpoint(ckpt)
        assert b._checkpoint_epoch == 3
        b.train(data, 6, iter_beg=3, strategy=second)
        np.testing.assert_allclose(
            np.asarray(b.quantization_errors(data)), qe_full, rtol=0.05
        )
