"""Regression tests for the round-2 review findings (memory budgeting of
matrix-materializing paths, distance_from_weights weights=, tiny-map
grid-mesh topographic error)."""

import jax.numpy as jnp
import numpy as np
import pytest

from xpysom_dask_tpu import XPySom
from xpysom_dask_tpu.utils.hw import default_n_parallel


def test_distance_from_weights_honors_weights_argument():
    rng = np.random.RandomState(0)
    data = rng.rand(40, 6).astype(np.float32)
    other = rng.rand(12, 6).astype(np.float32)  # 4x3 grid worth of rows
    som = XPySom(4, 3, 6, random_seed=1)
    d_own = som.distance_from_weights(data)
    d_other = som.distance_from_weights(data, weights=other)
    ref = np.linalg.norm(
        data[:, None].astype(np.float64) - other[None].astype(np.float64),
        axis=-1,
    )
    np.testing.assert_allclose(d_other, ref, rtol=1e-5, atol=1e-5)
    assert not np.allclose(d_own, d_other)


def test_matrix_chunk_budgeted_on_auto_but_honors_explicit():
    som = XPySom(4, 4, 3, random_seed=1)  # auto n_parallel
    assert not som._n_parallel_explicit
    # simulate the fused-kernel default landing on a huge codebook
    som._x = som._y = 512
    som._n_parallel = 16384
    budget = default_n_parallel(512 * 512, fused=False)
    assert som._matrix_chunk == min(16384, budget)
    assert som._matrix_chunk * 512 * 512 <= (1 << 24) + 256 * 512 * 512

    som2 = XPySom(4, 4, 3, n_parallel=16384, random_seed=1)
    assert som2._n_parallel_explicit
    assert som2._matrix_chunk == 16384  # user's memory bound is theirs


def test_wide_feature_auto_chunk_stays_budgeted(monkeypatch):
    # input_len > the kernel's MAX_D means the XLA path materializes the
    # distance matrix even for euclidean: the auto default must use the
    # element budget, not the fused chunk (regression: ctor consulted
    # only the distance name)
    from xpysom_dask_tpu import core
    from xpysom_dask_tpu.ops.pallas.bmu import MAX_D

    monkeypatch.setattr(
        "xpysom_dask_tpu.utils.hw.backend_kind", lambda: "gpu"
    )
    monkeypatch.setattr(core.jax, "default_backend", lambda: "gpu")
    som = XPySom(64, 64, MAX_D + 8, random_seed=1)
    assert som._n_parallel <= default_n_parallel(64 * 64, backend="gpu")
    monkeypatch.setenv("XPYSOM_NO_PALLAS", "1")
    som2 = XPySom(64, 64, 8, random_seed=1)
    assert som2._n_parallel <= default_n_parallel(64 * 64, backend="gpu")


def test_grid_mesh_tiny_map_topographic_error_falls_back():
    import jax

    from xpysom_dask_tpu.parallel import make_grid_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    rng = np.random.RandomState(2)
    data = rng.rand(200, 5).astype(np.float32)
    mesh = make_grid_mesh(2, 2)
    # 2x1 map over 2 model shards -> 1 codebook row per shard: the sharded
    # top-2 merge is undefined, must fall back to the replicated path
    som = XPySom(2, 1, 5, sigma=1.0, random_seed=3, mesh=mesh)
    te = som.topographic_error(data)
    ref = XPySom(2, 1, 5, sigma=1.0, random_seed=3).topographic_error(data)
    assert te == pytest.approx(ref)


def test_fractional_p_never_dispatches_even_kernel(monkeypatch):
    """norm_p, whatever its p, never reaches the fused kernel (which
    computes the euclidean/cosine metric only): every p takes the XLA
    path, fractional, integer-valued float, odd and even alike."""
    from xpysom_dask_tpu import core
    from xpysom_dask_tpu.ops.distances import DistanceFunction

    monkeypatch.setattr(core.jax, "default_backend", lambda: "gpu")
    for p in (2.5, 3.5, 3.0, 4.0, 2):
        assert (
            core._pallas_bmu_kind(DistanceFunction("norm_p", {"p": p}), 8)
            is None
        ), p


def test_streaming_predict_empty_source():
    from xpysom_dask_tpu import XPySom
    from xpysom_dask_tpu.parallel.pipeline import ArraySource

    som = XPySom(4, 4, 3, random_seed=1)
    out = som.predict(ArraySource(np.empty((0, 3), np.float32)))
    assert out.shape == (0,) and out.dtype == np.int64


def test_streaming_qe_checks_feature_count():
    from xpysom_dask_tpu import XPySom
    from xpysom_dask_tpu.parallel.pipeline import ArraySource

    som = XPySom(4, 4, 3, random_seed=1)
    bad = ArraySource(np.random.rand(50, 5).astype(np.float32))
    with pytest.raises(ValueError, match="features"):
        som.quantization_error(bad)
    with pytest.raises(ValueError, match="features"):
        som.predict(bad)


def test_env_tiles_reach_kernel_call(monkeypatch):
    """XPYSOM_BMU_TILES must reach the kernel: the kernel is env-blind by
    design, so the contract is env -> SomSpec.bmu_tiles at construction
    -> blocks= at the dispatch's kernel call."""
    import functools

    from xpysom_dask_tpu import XPySom, core
    from xpysom_dask_tpu.ops.pallas import bmu as pl_bmu

    rng = np.random.RandomState(0)
    x = rng.rand(40, 5).astype(np.float32)
    w = rng.rand(150, 5).astype(np.float32)
    monkeypatch.setenv("XPYSOM_BMU_TILES", "16x32")
    som = XPySom(10, 15, 5, random_seed=1)
    assert som._spec.bmu_tiles == (16, 32)
    seen = {}
    real = pl_bmu.searcher

    def spy(*a, **kw):
        seen["blocks"] = kw.get("blocks")
        return functools.partial(real, interpret=True)(*a, **kw)

    monkeypatch.setattr(pl_bmu, "searcher", spy)
    monkeypatch.setattr(core.jax, "default_backend", lambda: "gpu")
    idx = core._bmu_chunk(
        som._spec.distance_fn(), jnp.asarray(x), jnp.asarray(w), None, som._spec
    )
    assert seen.get("blocks") == (16, 32)
    ref = ((x[:, None] - w[None]) ** 2).sum(-1).argmin(1)
    np.testing.assert_array_equal(np.asarray(idx), ref)


# -- round-4 whole-package review fixes ---------------------------------------


def test_norm_p_float_even_p_xla_path():
    """A float integral p (2.0) selects the even GEMM branch exactly like
    the Pallas gate; range(p+1) must not TypeError (review r4)."""
    import jax.numpy as jnp

    from xpysom_dask_tpu.ops.distances import norm_p_power_distance

    x = np.random.RandomState(0).rand(6, 3).astype(np.float32)
    w = np.random.RandomState(1).rand(8, 3).astype(np.float32)
    d_f = np.asarray(norm_p_power_distance(jnp.asarray(x), jnp.asarray(w), p=2.0))
    d_i = np.asarray(norm_p_power_distance(jnp.asarray(x), jnp.asarray(w), p=2))
    np.testing.assert_allclose(d_f, d_i, rtol=1e-6)
    # end-to-end on the XLA fallback (the crash site)
    som = XPySom(
        4, 4, 3, activation_distance="norm_p",
        activation_distance_kwargs={"p": 2.0}, use_pallas=False,
        random_seed=0,
    )
    som.train(np.random.RandomState(2).rand(40, 3).astype(np.float32), 2)
    assert np.isfinite(som.get_weights()).all()


def test_norm_p_ignores_precision_modes(monkeypatch):
    """A process-global XPYSOM_BMU_PRECISION applies to norm_p specs like
    any other, but norm_p always takes the exact XLA path, so every mode
    trains the same map."""
    data = np.random.RandomState(2).rand(60, 3).astype(np.float32)
    maps = []
    for mode in ("packed", "bf16", "highest"):
        monkeypatch.setenv("XPYSOM_BMU_PRECISION", mode)
        som = XPySom(4, 4, 3, activation_distance="norm_p",
                     activation_distance_kwargs={"p": 4}, random_seed=0)
        assert som._bmu_precision == mode
        som.train(data, 2)
        maps.append(som.get_weights())
    np.testing.assert_array_equal(maps[0], maps[1])
    np.testing.assert_array_equal(maps[0], maps[2])


def test_boolean_env_switches_treat_zero_as_off(monkeypatch):
    """FLAG=0 / false / off means OFF for every boolean XPYSOM_* switch
    (review r4: bare truthiness read '0' as ON)."""
    from xpysom_dask_tpu.utils.envflags import env_flag

    for v in ("0", "false", "no", "off", "", "FALSE", " 0 "):
        monkeypatch.setenv("XPYSOM_TEST_FLAG", v)
        assert env_flag("XPYSOM_TEST_FLAG") is False, v
    for v in ("1", "true", "yes", "anything"):
        monkeypatch.setenv("XPYSOM_TEST_FLAG", v)
        assert env_flag("XPYSOM_TEST_FLAG") is True, v
    monkeypatch.setenv("XPYSOM_NO_PALLAS", "0")
    assert XPySom(4, 4, 3)._use_pallas is True
    monkeypatch.setenv("XPYSOM_NO_PALLAS", "1")
    assert XPySom(4, 4, 3)._use_pallas is False


def test_streaming_inference_gated_on_multihost_mesh(monkeypatch):
    """Streaming INFERENCE over a process-spanning mesh raises a clear
    NotImplementedError instead of desyncing collectives (review r4;
    streamed TRAINING is synchronized and allowed)."""
    import xpysom_dask_tpu.parallel.mesh as mesh_mod
    from xpysom_dask_tpu.parallel.pipeline import ArraySource

    som = XPySom(4, 4, 3, random_seed=0, mesh="auto")
    data = np.random.RandomState(0).rand(64, 3).astype(np.float32)
    som.train(data, 1)
    monkeypatch.setattr(mesh_mod, "mesh_spans_processes", lambda m: True)
    for call in (
        lambda: som.predict(ArraySource(data)),
        lambda: som.quantization_error(ArraySource(data)),
        lambda: som.topographic_error(ArraySource(data)),
        lambda: som.activation_response(ArraySource(data)),
    ):
        with pytest.raises(NotImplementedError, match="multi-host"):
            call()
    # resident inference on the same mesh is unaffected
    monkeypatch.undo()
    assert som.predict(data).shape == (64,)


def test_sklearn_inverse_transform_validates_labels():
    from xpysom_dask_tpu.sklearn import SomClusterer

    X = np.random.RandomState(0).rand(60, 4).astype(np.float32)
    clf = SomClusterer(4, 4, num_epochs=2, random_seed=1).fit(X)
    ok = clf.inverse_transform([0, 15])
    assert ok.shape == (2, 4)
    with pytest.raises(ValueError, match="grid indices"):
        clf.inverse_transform([-1])  # sklearn noise label must not wrap
    with pytest.raises(ValueError, match="grid indices"):
        clf.inverse_transform([16])
    assert clf.inverse_transform(np.empty(0, np.int64)).shape == (0, 4)


def test_default_n_parallel_respects_budget():
    """Rounding must go DOWN so the (chunk, XY) transient never exceeds
    the element budget (review r4: xy=4000 rounded 262 up to 512)."""
    from xpysom_dask_tpu.utils import hw

    chunk = hw.default_n_parallel(4000, backend="cpu")
    assert chunk % 256 == 0
    assert chunk * 4000 <= hw._CPU_BUDGET or chunk == 256
    big = hw.default_n_parallel(1, backend="cpu")
    assert big == 65536  # clamp ceiling intact


def test_epoch_anatomy_public_api():
    """epoch_anatomy returns a per-stage decomposition with finite,
    positive epoch cost and consistent derived fields — mechanics only on
    CPU; the numbers that matter are measured on the card."""
    from xpysom_dask_tpu.utils.profiling import epoch_anatomy

    som = XPySom(6, 6, 8, random_seed=0, n_parallel=256)
    data = np.random.RandomState(0).rand(512, 8).astype(np.float32)
    out = epoch_anatomy(som, data, lo=1, hi=3, reps=2)
    for k in ("bmu_ms", "stats_ms", "epoch_ms", "scatter_ms", "update_ms"):
        assert k in out and np.isfinite(out[k]), (k, out)
    assert out["epoch_ms"] > 0
    assert abs(
        out["bmu_ms"] + out["scatter_ms"] + out["update_ms"] - out["epoch_ms"]
    ) < 1e-9


# ---------------------------------------------------------------------------
# Round-5 tail review findings
# ---------------------------------------------------------------------------


def test_norm_p_negative_even_p_routes_generic():
    """p=-2 satisfies ``p % 2 == 0`` but has no binomial expansion
    (``range(p+1)`` is empty — the dispatcher used to return an all-zeros
    "distance" silently); it must ride the generic pow path."""
    from xpysom_dask_tpu.ops import distances as D

    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.rand(6, 5).astype(np.float32) + 0.5)
    w = jnp.asarray(rng.rand(7, 5).astype(np.float32) + 0.5)
    got = np.asarray(D.norm_p_power_distance(x, w, p=-2))
    want = np.asarray(D.norm_p_power_distance_generic(x, w, p=-2))
    assert np.all(want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError):
        D.norm_p_power_distance_even(x, w, p=-2)
    with pytest.raises(ValueError):
        D.norm_p_power_distance_even(x, w, p=0)


def test_split2_raw_wsq_wrappers_match_highest():
    """The cosine wrapper rides the euclidean kernel with a SEMANTIC-zero
    ``w_sq``; split2 must honor it (``w_sq_raw=True``) instead of
    substituting its self-consistent rounded-codebook norm — which is only
    a valid replacement for the euclidean ``Σw²``. Winners match the
    highest-precision XLA cosine path."""
    from xpysom_dask_tpu.ops.distances import DistanceFunction
    from xpysom_dask_tpu.ops.pallas.bmu import bmu_cosine

    rng = np.random.RandomState(2)
    x = jnp.asarray(((rng.rand(64, 16) - 0.5) * 4).astype(np.float32))
    w = jnp.asarray(((rng.rand(32, 16) - 0.5) * 4).astype(np.float32))
    i_hi = jnp.argmin(DistanceFunction("cosine").flat(x, w), axis=1)
    i_s2, _ = bmu_cosine(x, w, interpret=True, mode="split2")
    np.testing.assert_array_equal(np.asarray(i_s2), np.asarray(i_hi))


def test_split2_raw_wsq_honors_caller_w_sq():
    """Direct-kernel pin of the mechanism: with ``w_sq=0`` and codebook
    rows of wildly different norms, raw split2 must rank by the pure dot
    (matching float64, which always honors ``w_sq``), while the
    non-raw branch's substituted ``¼·Σ(w_h)²`` bias changes winners."""
    from xpysom_dask_tpu.ops.pallas.bmu import bmu_euclidean

    rng = np.random.RandomState(3)
    w_np = ((rng.rand(24, 8) - 0.5) * 2).astype(np.float32)
    w_np *= (10.0 ** rng.randint(0, 3, size=(24, 1))).astype(np.float32)
    x = jnp.asarray(((rng.rand(48, 8) - 0.5) * 2).astype(np.float32))
    w = jnp.asarray(w_np)
    zeros = jnp.zeros((24, 1), jnp.float32)
    i_hi = np.argmax(np.asarray(x, np.float64) @ w_np.T.astype(np.float64), 1)
    i_raw, _ = bmu_euclidean(
        x, w, zeros, interpret=True, mode="split2", w_sq_raw=True
    )
    i_old, _ = bmu_euclidean(
        x, w, zeros, interpret=True, mode="split2", w_sq_raw=False
    )
    np.testing.assert_array_equal(np.asarray(i_raw), np.asarray(i_hi))
    # the substituted norm is a real per-node bias on these inputs
    assert np.any(np.asarray(i_old) != np.asarray(i_hi))


def test_streaming_chunk_aligned_to_sample_tile(monkeypatch):
    """Streaming training must apply the SAME row-block chunk alignment
    as the resident path (utils.hw.training_chunk) — an unaligned chunk
    (e.g. a raw n_parallel of 1800) would pad inside every scan step."""
    import xpysom_dask_tpu.parallel.pipeline as pl
    from xpysom_dask_tpu.core import SomSpec
    from xpysom_dask_tpu.models.population import SomPopulation
    from xpysom_dask_tpu.parallel.pipeline import ArraySource

    captured = []
    real = pl.stats_streaming

    def spy(spec, w, source, chunk, superbatch_rows, mesh=None, stats_fn=None):
        captured.append(chunk)
        return real(
            spec, w, source, chunk, superbatch_rows, mesh, stats_fn=stats_fn
        )

    monkeypatch.setattr(pl, "stats_streaming", spy)
    rng = np.random.RandomState(0)
    data = rng.rand(96, 4).astype(np.float32)
    spec = SomSpec(x=4, y=4, input_len=4, sigma=2.0, sigmaN=1.0,
                   learning_rate=0.5, learning_rateN=0.01)
    w0 = rng.rand(4, 4, 4).astype(np.float32)
    pl.train_streaming(
        spec, w0, ArraySource(data), 1, chunk=1800, superbatch_rows=4096
    )
    assert captured[-1] == 1792
    # small explicit chunks pass through unchanged (tests rely on them)
    pl.train_streaming(
        spec, w0, ArraySource(data), 1, chunk=16, superbatch_rows=64
    )
    assert captured[-1] == 16

    # the population streaming path (default 'auto' -> fused) shares it
    pop = SomPopulation(2, 4, 4, 4, sigma=2.0, random_seed=0, n_parallel=1800)
    pop.train(ArraySource(data), 1)
    assert captured[-1] == 1792


def test_empty_input_contract_resident():
    """Resident QE/TE warn and return NaN on zero rows (the contract the
    streaming branches and SomPopulation already document); predict and
    winner return empty results; wrong-width inputs raise the
    reference-style ValueError on every inference entry point."""
    som = XPySom(5, 5, 4, sigma=2.0, random_seed=0)
    data = np.random.RandomState(0).rand(64, 4).astype(np.float32)
    som.train(data, 2)
    empty = np.empty((0, 4), np.float32)
    with pytest.warns(UserWarning, match="no rows"):
        assert np.isnan(som.quantization_error(empty))
    with pytest.warns(UserWarning, match="no rows"):
        assert np.isnan(som.topographic_error(empty))
    assert som.predict(empty).shape == (0,)
    assert som.winner(empty) == []
    assert som.quantization(empty).shape == (0, 4)
    wrong = np.zeros((3, 5), np.float32)
    for f in (som.predict, som.winner, som.activate,
              som.quantization_error, som.topographic_error):
        with pytest.raises(ValueError, match="features"):
            f(wrong)
    with pytest.raises(ValueError, match="features"):
        som.quantization_error(np.empty((0, 5), np.float32))


def test_legacy_pickle_without_explicit_flags_checkpoints():
    """Pickles from before the *_explicit kernel-config flags must
    restore with auto semantics: save_checkpoint and _matrix_chunk read
    those attributes directly (they raised AttributeError before)."""
    import os
    import tempfile

    som = XPySom(5, 5, 4, sigma=2.0, random_seed=0)
    data = np.random.RandomState(0).rand(64, 4).astype(np.float32)
    som.train(data, 2)
    state = dict(som.__getstate__())
    for k in ("_use_pallas_explicit", "_bmu_precision_explicit",
              "_bmu_tiles_explicit", "_n_parallel_explicit"):
        state.pop(k, None)
    legacy = XPySom.__new__(XPySom)
    legacy.__setstate__(state)
    assert legacy._n_parallel_explicit is False
    assert legacy._matrix_chunk > 0
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "legacy.npz")
        legacy.save_checkpoint(path)
        back = XPySom.load_checkpoint(path)
    np.testing.assert_array_equal(back.get_weights(), som.get_weights())
    assert back.winner(data[:3]) == som.winner(data[:3])


def test_activate_is_chunked_and_matches_whole():
    """activate() must budget the (N, XY) matrix like its sibling
    distance_from_weights instead of one unbounded device call; chunked
    output equals the single-call result exactly."""
    som_whole = XPySom(5, 5, 4, sigma=2.0, random_seed=0)
    som_chunked = XPySom(5, 5, 4, sigma=2.0, random_seed=0, n_parallel=8)
    data = np.random.RandomState(0).rand(30, 4).astype(np.float32)
    assert som_chunked._matrix_chunk == 8  # forces 4 chunks
    a = som_chunked.activate(data)
    b = som_whole.activate(data)
    assert a.shape == (30, 25)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    # scalar/1-D samples keep working (the planted-fixture probe shape)
    assert som_whole.activate(np.float32([0.1, 0.2, 0.3, 0.4])).shape == (1, 25)


# ---------------------------------------------------------------------------
# round-5 close-out review fixes (second high-effort package review)
# ---------------------------------------------------------------------------


def test_legacy_population_pickle_checkpoints_as_auto():
    """A SomPopulation unpickled from before the *_explicit flags must
    checkpoint its n_parallel as AUTO (0 in the header), matching the
    single-model _config_dict stance — persisting the resolved value as
    user-explicit would drop the _matrix_chunk budget on reload."""
    import json
    import os
    import tempfile

    from xpysom_dask_tpu import SomPopulation

    pop = SomPopulation(2, 4, 4, 6, random_seed=3)
    state = pop.__getstate__()
    state.pop("_n_parallel_explicit", None)  # simulate a legacy pickle
    legacy = SomPopulation.__new__(SomPopulation)
    legacy.__setstate__(state)
    assert legacy._n_parallel_explicit is False
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "legacy_pop.npz")
        legacy.save_checkpoint(path)
        with np.load(path) as z:
            header = json.loads(bytes(z["header"]).decode())
        assert header["population"]["n_parallel"] == 0
        back = SomPopulation.load_checkpoint(path)
    assert back._n_parallel_explicit is False
    np.testing.assert_array_equal(back.weights, pop.weights)


def test_sklearn_clusterer_forwards_activation_distance_kwargs():
    """SomClusterer(activation_distance='norm_p', activation_distance_
    kwargs={'p': 3}) must reach the underlying XPySom — it silently ran
    with the default p=2 before."""
    from xpysom_dask_tpu.sklearn import SomClusterer

    X = np.random.RandomState(0).rand(40, 6).astype(np.float32)
    clu = SomClusterer(
        4, 4, num_epochs=2, activation_distance="norm_p",
        activation_distance_kwargs={"p": 3}, random_seed=1,
    ).fit(X)
    assert clu.som_._activation_distance_kwargs == {"p": 3}
    assert dict(clu.som_._spec.distance_kwargs).get("p") == 3
    # sklearn clone() protocol: params round-trip verbatim
    params = clu.get_params()
    assert params["activation_distance_kwargs"] == {"p": 3}


def test_population_auto_members_self_size_like_standalone():
    """Auto-sized population members carry the standalone XPySom budget
    (the serial plan never materializes the concatenated matrix); the
    population-level concat budget still governs the stacked programs."""
    from xpysom_dask_tpu import SomPopulation

    pop = SomPopulation(64, 24, 24, 16, random_seed=0)
    lone = XPySom(24, 24, 16)
    assert pop.member(0)._n_parallel == lone._n_parallel
    assert not pop.member(0)._n_parallel_explicit
    # the stacked-program budget is against the concatenated matrix
    assert pop._n_parallel == default_n_parallel(64 * 24 * 24, fused=False)


def test_apply_operator_rejects_unknown_kind():
    from xpysom_dask_tpu.ops.neighborhoods import apply_operator

    with pytest.raises(ValueError, match="operator kind"):
        apply_operator(
            ("full", np.eye(4, dtype=np.float32)),
            jnp.zeros((4, 2)), jnp.zeros((4,)),
        )


# ---------------------------------------------------------------------------
# round-5 third-review fixes (inference budgets, hoisted uploads, bucketing)
# ---------------------------------------------------------------------------


def test_inference_chunk_never_exceeds_tiny_explicit_budget():
    """A user n_parallel < 8 is a memory budget: bucketed inference must
    not round it UP to a lane group (regression: max(8, ...) silently
    doubled n_parallel=4)."""
    from xpysom_dask_tpu.utils.hw import inference_chunk

    for cap in range(1, 8):
        chunk, _ = inference_chunk(100, cap)
        assert chunk == cap  # unaligned but honored
    # at/above 8 rows the cap rounds DOWN to its alignment (whole row
    # blocks above one block)
    assert inference_chunk(100, 500)[0] == 384
    assert inference_chunk(100, 100)[0] == 96
    assert inference_chunk(4, 500)[0] == 8  # ladder rung
    assert inference_chunk(100, 4096)[0] == 512  # ladder rung under cap

    som = XPySom(4, 4, 6, n_parallel=4, random_seed=1)
    data = np.random.RandomState(0).rand(10, 6).astype(np.float32)
    chunks, mask, n = som._chunked(data, bucket=True)
    assert chunks.shape[1] <= 4
    assert n == 10
    # the budget-honoring chunks still drive the public inference path
    w = som.winner(data)
    assert len(w) == 10


def test_population_fused_chunks_are_member_sized():
    """strategy='fused' runs per-member fused kernels (no concatenated
    matrix): its chunks take the MEMBER budget, not the ~64x smaller
    concat budget the 'batched' plan needs (round-5 third review)."""
    from xpysom_dask_tpu import SomPopulation
    from xpysom_dask_tpu.utils.hw import training_chunk

    pop = SomPopulation(64, 24, 24, 16, random_seed=0)
    n = 8192
    data = np.random.RandomState(1).rand(n, 16).astype(np.float32)
    member_np = pop.member(0)._n_parallel
    assert pop._stats_n_parallel("fused") == member_np
    assert pop._stats_n_parallel("concat") == pop._n_parallel
    chunks_f, _, _ = pop._chunked(data, "fused")
    chunks_c, _, _ = pop._chunked(data, "concat")
    assert chunks_f.shape[1] == training_chunk(n, member_np)
    assert chunks_c.shape[1] == training_chunk(n, pop._n_parallel)
    assert chunks_f.shape[1] > chunks_c.shape[1]  # the regression's point


def test_population_fused_member_chunks_keep_parity():
    """Member-sized fused chunks change summation grouping only; the
    trained weights stay within fp tolerance of the batched plan."""
    from xpysom_dask_tpu import SomPopulation

    data = np.random.RandomState(2).rand(600, 8).astype(np.float32)
    a = SomPopulation(3, 6, 6, 8, random_seed=7)
    b = SomPopulation(3, 6, 6, 8, random_seed=7)
    a.train(data, 3, strategy="fused")
    b.train(data, 3, strategy="batched")
    np.testing.assert_allclose(a.weights, b.weights, rtol=2e-4, atol=2e-4)


def test_streaming_topographic_error_uploads_codebook_once(monkeypatch):
    """Streaming TE hoists the codebook upload out of the superbatch loop
    like predict/QE/activation_response (regression: one device_put per
    superbatch block)."""
    som = XPySom(6, 6, 8, random_seed=3)
    data = np.random.RandomState(4).rand(300, 8).astype(np.float32)
    som.train(data, 2)
    resident = som.topographic_error(data)

    monkeypatch.setattr(XPySom, "_superbatch_rows", lambda self: 100)
    calls = {"n": 0}
    orig = XPySom._device_weights

    def counting(self):
        calls["n"] += 1
        return orig(self)

    monkeypatch.setattr(XPySom, "_device_weights", counting)
    from xpysom_dask_tpu.parallel.pipeline import ArraySource

    streamed = som.topographic_error(ArraySource(data))
    assert calls["n"] == 1  # hoisted: one upload for three superbatches
    np.testing.assert_allclose(streamed, resident, rtol=1e-6, atol=1e-9)


def test_population_streaming_qe_buckets_tail_blocks():
    """Streaming quantization_errors snaps blocks onto the inference
    ladder so a tail block with a distinct length reuses the compiled
    shape instead of recompiling the QE executable (round-5 third
    review); values still match the resident evaluation."""
    from xpysom_dask_tpu import SomPopulation
    from xpysom_dask_tpu.parallel.pipeline import ArraySource

    pop = SomPopulation(3, 5, 5, 8, random_seed=5)
    data = np.random.RandomState(6).rand(137, 8).astype(np.float32)
    pop.train(data, 2)
    # same padded shape class for different block lengths in one rung
    s1 = pop._chunked(data[:100], bucket=True)[0].shape
    s2 = pop._chunked(data[:90], bucket=True)[0].shape
    assert s1 == s2
    # and distinct shapes stay on the bounded ladder, not per-length
    s3 = pop._chunked(data[:37], bucket=True)[0].shape
    assert s3[1] in (8, 64, 512)
    resident = pop.quantization_errors(data)
    streamed = pop.quantization_errors(ArraySource(data))
    np.testing.assert_allclose(streamed, resident, rtol=1e-6, atol=1e-9)
