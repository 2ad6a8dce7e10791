"""First-class kernel configuration (VERDICT r2 #3).

The reference's whole config system is constructor kwargs validated with
ValueErrors (reference xpysom.py:73-161). The fused-kernel runtime
choices — ``bmu_precision``, ``bmu_tiles``, ``use_pallas`` — are held to
the same bar: constructor kwargs resolved ONCE at construction (env
switches only supply defaults), carried in the hashable ``SomSpec`` so
every jit cache keys on them, and persisted in checkpoint headers.
"""

import dataclasses
import pickle

import numpy as np
import pytest

from xpysom_dask_tpu import XPySom
from xpysom_dask_tpu import core
from xpysom_dask_tpu.core import SomSpec
from xpysom_dask_tpu.ops.distances import DistanceFunction


def _data(n=64, d=8, seed=3):
    return np.random.RandomState(seed).rand(n, d).astype(np.float32)


# -- constructor validation ---------------------------------------------------


def test_bad_precision_raises():
    # the constructor delegates to the ONE validation boundary
    # (SomSpec.__post_init__) — same error for XPySom and SomSpec
    with pytest.raises(ValueError, match="bmu_precision.*not recognized"):
        XPySom(4, 4, 8, bmu_precision="float16")


@pytest.mark.parametrize(
    "tiles", [(7, 128), (8, 100), (0, 128), (8, 0), (-8, 128), ("a", "b"), (8,)]
)
def test_bad_tiles_raise(tiles):
    with pytest.raises(ValueError, match="bmu_tiles"):
        XPySom(4, 4, 8, bmu_tiles=tiles)


def test_valid_config_accepted():
    som = XPySom(
        4, 4, 8, bmu_precision="bf16", bmu_tiles=(512, 2048), use_pallas=True
    )
    assert som._bmu_precision == "bf16"
    assert som._bmu_tiles == (512, 2048)
    assert som._use_pallas is True


# -- spec carriage: jit caches key on the config ------------------------------


def test_spec_carries_config():
    som = XPySom(4, 4, 8, bmu_precision="highest", bmu_tiles=(16, 128))
    spec = som._spec
    assert spec.bmu_precision == "highest"
    assert spec.bmu_tiles == (16, 128)
    assert spec.use_pallas in (True, False)
    # distinct configs -> distinct (hashable) specs -> distinct jit caches
    other = XPySom(4, 4, 8, bmu_precision="packed", bmu_tiles=(16, 128))
    assert spec != other._spec
    assert hash(spec) != hash(other._spec) or spec != other._spec


def test_default_precision_packed_and_norm_p_highest():
    """'packed' is the default for every activation; norm_p never reaches
    the kernel (it always takes the exact XLA path), so it needs no
    'highest' default of its own."""
    assert XPySom(4, 4, 8)._bmu_precision == "packed"
    assert (
        XPySom(
            4, 4, 8, activation_distance="norm_p",
            activation_distance_kwargs={"p": 4},
        )._bmu_precision
        == "packed"
    )


# -- env switches: read once at construction, kwargs win ----------------------


def test_env_read_once_at_construction(monkeypatch):
    monkeypatch.setenv("XPYSOM_BMU_PRECISION", "bf16")
    monkeypatch.setenv("XPYSOM_BMU_TILES", "512x1024")
    monkeypatch.setenv("XPYSOM_NO_PALLAS", "1")
    som = XPySom(4, 4, 8)
    monkeypatch.delenv("XPYSOM_BMU_PRECISION")
    monkeypatch.delenv("XPYSOM_BMU_TILES")
    monkeypatch.delenv("XPYSOM_NO_PALLAS")
    # resolved values survive env removal — no trace-time staleness
    assert som._bmu_precision == "bf16"
    assert som._bmu_tiles == (512, 1024)
    assert som._use_pallas is False
    assert som._spec.bmu_precision == "bf16"
    # a freshly built SOM goes back to the defaults
    fresh = XPySom(4, 4, 8)
    assert fresh._bmu_precision == "packed"
    assert fresh._bmu_tiles is None
    assert fresh._use_pallas is True


def test_explicit_kwargs_beat_env(monkeypatch):
    monkeypatch.setenv("XPYSOM_BMU_PRECISION", "bf16")
    monkeypatch.setenv("XPYSOM_NO_PALLAS", "1")
    som = XPySom(4, 4, 8, bmu_precision="split2", use_pallas=True)
    assert som._bmu_precision == "split2"
    assert som._use_pallas is True


# -- dispatch honors the config -----------------------------------------------


def test_use_pallas_false_short_circuits_kind():
    d = DistanceFunction("euclidean")
    assert core._pallas_bmu_kind(d, 8, False) is None


def test_bmu_chunk_threads_mode_and_tiles(monkeypatch):
    """The spec's mode/tiles reach the kernel call — checked by swapping
    the kernel for a recorder and forcing the dispatch to 'euclidean'
    (the kernel itself is exercised in test_pallas.py and tests_gpu/)."""
    import jax.numpy as jnp

    import xpysom_dask_tpu.ops.pallas.bmu as bmu_mod

    calls = {}

    def fake_searcher(w_flat, w_sq=None, *, center=None, mode, top2, blocks):
        calls["mode"] = mode
        calls["tiles"] = blocks
        return lambda x: (jnp.zeros(x.shape[0], jnp.int32), jnp.zeros(x.shape[0]))

    monkeypatch.setattr(bmu_mod, "searcher", fake_searcher)
    monkeypatch.setattr(
        core, "_pallas_bmu_kind",
        lambda dist, d_dim, use_pallas=None, mode=None: "euclidean",
    )
    spec = SomSpec(
        x=4, y=4, input_len=8, sigma=2.0, sigmaN=1.0,
        learning_rate=0.5, learning_rateN=0.01,
        bmu_precision="bf16", bmu_tiles=(512, 2048), use_pallas=True,
    )
    x = jnp.zeros((4, 8), jnp.float32)
    w = jnp.zeros((16, 8), jnp.float32)
    core._bmu_chunk(spec.distance_fn(), x, w, None, spec)
    assert calls == {"mode": "bf16", "tiles": (512, 2048)}
    # None spec: the kernel defaults ('packed', the per-width block
    # table) — the kernel never reads env
    core._bmu_chunk(spec.distance_fn(), x, w, None, None)
    assert calls == {"mode": "packed", "tiles": None}


def test_mode_switch_in_one_process():
    """Two SOMs with different precisions train in the same process and
    both produce finite, valid codebooks (each compiles its own
    executable because the spec hash differs)."""
    data = _data()
    outs = []
    for prec in ("packed", "bf16"):
        som = XPySom(4, 4, 8, random_seed=1, bmu_precision=prec)
        som.train(data, 2)
        outs.append(som.get_weights())
    for w in outs:
        assert np.isfinite(w).all()
    # on CPU both run the XLA path -> identical results; the point is
    # neither crashed nor reused the other's trace
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6)


# -- direct-core users: the spec IS the boundary (VERDICT r3 #5) ---------------


def test_spec_post_init_resolves_env(monkeypatch):
    """Bare SomSpec construction resolves the env switches exactly like
    XPySom construction — direct core users get the same single
    documented boundary, and env changes apply to NEW specs only (the
    old spec, and every jit cache keyed on it, is untouched)."""
    monkeypatch.setenv("XPYSOM_BMU_PRECISION", "bf16")
    monkeypatch.setenv("XPYSOM_BMU_TILES", "512x1024")
    monkeypatch.setenv("XPYSOM_NO_PALLAS", "1")
    a = SomSpec(4, 4, 8, 2.0, 1.0, 0.5, 0.01)
    assert (a.bmu_precision, a.bmu_tiles, a.use_pallas) == (
        "bf16", (512, 1024), False,
    )
    monkeypatch.delenv("XPYSOM_BMU_PRECISION")
    monkeypatch.delenv("XPYSOM_BMU_TILES")
    monkeypatch.delenv("XPYSOM_NO_PALLAS")
    b = SomSpec(4, 4, 8, 2.0, 1.0, 0.5, 0.01)
    assert (b.bmu_precision, b.bmu_tiles, b.use_pallas) == (
        "packed", None, True,
    )
    # resolved values participate in eq/hash -> distinct jit cache keys
    assert a != b
    # the earlier spec kept its construction-time resolution
    assert a.bmu_precision == "bf16"
    # explicit fields win over env
    monkeypatch.setenv("XPYSOM_BMU_PRECISION", "bf16")
    c = SomSpec(4, 4, 8, 2.0, 1.0, 0.5, 0.01, bmu_precision="highest")
    assert c.bmu_precision == "highest"
    # norm_p takes the same default as every activation
    monkeypatch.delenv("XPYSOM_BMU_PRECISION")
    d = SomSpec(4, 4, 8, 2.0, 1.0, 0.5, 0.01, distance="norm_p",
                distance_kwargs=(("p", 4),))
    assert d.bmu_precision == "packed"


def test_env_junk_warns_at_construction(monkeypatch):
    """Env-sourced junk warns and falls back (a stale env var must not
    break every constructor in the process); explicit kwargs still
    raise (test_bad_precision_raises)."""
    monkeypatch.setenv("XPYSOM_BMU_PRECISION", "float16")
    with pytest.warns(UserWarning, match="XPYSOM_BMU_PRECISION"):
        som = XPySom(4, 4, 8)
    assert som._bmu_precision == "packed"
    with pytest.warns(UserWarning, match="XPYSOM_BMU_PRECISION"):
        spec = SomSpec(4, 4, 8, 2.0, 1.0, 0.5, 0.01)
    assert spec.bmu_precision == "packed"


def test_no_env_reads_while_tracing(monkeypatch):
    """No traced/jitted call path reads the XPYSOM_* env switches: with
    a guard that raises on any XPYSOM_* access, building + tracing +
    running the full epoch/train executables must succeed (the grep
    criterion of VERDICT r3 #5, enforced at runtime)."""
    import os as _os

    import jax.numpy as jnp

    spec = SomSpec(4, 4, 8, 2.0, 1.0, 0.5, 0.01)  # boundary: resolves here

    real_environ = _os.environ

    class _Guard:
        def get(self, key, default=None):
            if str(key).startswith("XPYSOM_"):
                raise AssertionError(f"env read of {key} inside library code")
            return real_environ.get(key, default)

        def __getitem__(self, key):
            if str(key).startswith("XPYSOM_"):
                raise AssertionError(f"env read of {key} inside library code")
            return real_environ[key]

        def __contains__(self, key):
            return key in real_environ

        def __iter__(self):
            return iter(real_environ)

        # delegate the rest (jax/XLA may touch env during compile)
        def __getattr__(self, name):
            return getattr(real_environ, name)

    import xpysom_dask_tpu.core as core_mod

    data = jnp.asarray(_data(32, 8))
    chunks = data.reshape(2, 16, 8)
    mask = jnp.ones((2, 16), jnp.float32)
    w = jnp.asarray(np.random.RandomState(0).rand(4, 4, 8), jnp.float32)
    # the factory body reads the scatter hooks EAGERLY at build time —
    # allowed (that is the documented build boundary); build first
    step = core.make_epoch_fn.__wrapped__(spec, 3)  # bypass lru_cache

    guard = _Guard()
    # core holds the env-reading helpers; patching os.environ through its
    # os module patches it for every module
    monkeypatch.setattr(core_mod.os, "environ", guard, raising=True)
    try:
        # first call = trace + compile + run: no env read may happen here
        out = step(w, chunks, mask, jnp.int32(0))
        assert np.isfinite(np.asarray(out)).all()
    finally:
        monkeypatch.undo()


def test_direct_core_mode_switch_no_staleness(monkeypatch):
    """Direct-core mode switching: set env -> build spec A -> train;
    change env -> build spec B -> train. Each run uses its own
    construction-time config (distinct spec hash = distinct executable);
    nothing silently reuses the other's trace."""
    import jax.numpy as jnp

    captured = []

    def fake_searcher(w_flat, w_sq=None, *, center=None, mode, top2, blocks):
        captured.append((mode, blocks))
        return lambda x: (jnp.zeros(x.shape[0], jnp.int32), jnp.zeros(x.shape[0]))

    import xpysom_dask_tpu.ops.pallas.bmu as bmu_mod

    monkeypatch.setattr(bmu_mod, "searcher", fake_searcher)
    monkeypatch.setattr(
        core, "_pallas_bmu_kind",
        lambda dist, d_dim, use_pallas=None, mode=None: "euclidean",
    )
    x = jnp.zeros((4, 8), jnp.float32)
    w = jnp.zeros((16, 8), jnp.float32)

    monkeypatch.setenv("XPYSOM_BMU_PRECISION", "bf16")
    spec_a = SomSpec(4, 4, 8, 2.0, 1.0, 0.5, 0.01)
    core._bmu_chunk(spec_a.distance_fn(), x, w, None, spec_a)
    monkeypatch.setenv("XPYSOM_BMU_PRECISION", "highest")
    spec_b = SomSpec(4, 4, 8, 2.0, 1.0, 0.5, 0.01)
    core._bmu_chunk(spec_b.distance_fn(), x, w, None, spec_b)
    assert captured == [("bf16", None), ("highest", None)]


# -- persistence ---------------------------------------------------------------


def test_checkpoint_roundtrip_preserves_config(tmp_path):
    som = XPySom(
        4, 4, 8, random_seed=7,
        bmu_precision="split2", bmu_tiles=(1024, 2048), use_pallas=False,
    )
    som.train(_data(), 1)
    p = tmp_path / "ck"
    som.save_checkpoint(p, epoch=1)
    back = XPySom.load_checkpoint(p)
    assert back._bmu_precision == "split2"
    assert back._bmu_tiles == (1024, 2048)
    assert back._use_pallas is False
    np.testing.assert_array_equal(back.get_weights(), som.get_weights())


def test_checkpoint_hw_config_persists_only_when_explicit(tmp_path, monkeypatch):
    """ADVICE r3 (low): use_pallas/bmu_tiles are HARDWARE tuning — a
    checkpoint must not pin env-resolved values on a different machine,
    and XPYSOM_NO_PALLAS on the loading host must
    be honored. bmu_precision is numeric semantics and always travels."""
    monkeypatch.setenv("XPYSOM_BMU_TILES", "512x1024")  # env-resolved, not explicit
    som = XPySom(4, 4, 8, random_seed=7, bmu_precision="bf16")
    assert som._bmu_tiles == (512, 1024) and not som._bmu_tiles_explicit
    p = tmp_path / "ck"
    som.save_checkpoint(p)
    monkeypatch.delenv("XPYSOM_BMU_TILES")
    back = XPySom.load_checkpoint(p)
    assert back._bmu_tiles is None  # fresh resolution on the loading host
    assert back._bmu_precision == "bf16"  # numeric mode travels
    # the kill-switch works on loaded models (reference _no_opt pattern)
    monkeypatch.setenv("XPYSOM_NO_PALLAS", "1")
    back2 = XPySom.load_checkpoint(p)
    assert back2._use_pallas is False
    monkeypatch.delenv("XPYSOM_NO_PALLAS")
    # explicit values still travel (test_checkpoint_roundtrip_preserves_config)
    som3 = XPySom(4, 4, 8, use_pallas=True, bmu_tiles=(16, 128))
    som3.save_checkpoint(p)
    monkeypatch.setenv("XPYSOM_NO_PALLAS", "1")
    back3 = XPySom.load_checkpoint(p)
    assert back3._use_pallas is True and back3._bmu_tiles == (16, 128)


def test_checkpoint_auto_n_parallel_stays_auto(tmp_path):
    """ADVICE r2 (medium): a reloaded auto-sized SOM must keep the
    budgeted _matrix_chunk — persisting the resolved n_parallel made it
    look user-explicit, defeating the matrix-path memory guard."""
    som = XPySom(4, 4, 8, random_seed=7)  # n_parallel=0 -> auto
    assert not som._n_parallel_explicit
    p = tmp_path / "ck"
    som.save_checkpoint(p)
    back = XPySom.load_checkpoint(p)
    assert not back._n_parallel_explicit
    assert back._matrix_chunk == som._matrix_chunk
    # explicit stays explicit
    som2 = XPySom(4, 4, 8, n_parallel=2048)
    som2.save_checkpoint(p)
    back2 = XPySom.load_checkpoint(p)
    assert back2._n_parallel_explicit
    assert back2._n_parallel == 2048


def test_pickle_roundtrip_and_legacy_state():
    som = XPySom(4, 4, 8, bmu_precision="bf16", bmu_tiles=(16, 128))
    back = pickle.loads(pickle.dumps(som))
    assert back._bmu_precision == "bf16"
    assert back._bmu_tiles == (16, 128)
    # a pre-config pickle (no _bmu_* attrs) must load with defaults
    state = som.__getstate__()
    for k in ("_bmu_precision", "_bmu_tiles", "_use_pallas"):
        state.pop(k)
    legacy = XPySom.__new__(XPySom)
    legacy.__setstate__(state)
    assert legacy._bmu_precision == "packed"
    assert legacy._bmu_tiles is None
    assert legacy._use_pallas is True
    assert legacy._spec.bmu_precision == "packed"


# -- streaming empty-source guards (ADVICE r2 low) ----------------------------


class _EmptySource:
    def __len__(self):
        return 0

    def superbatches(self, rows):
        return iter(())


def test_streaming_qe_te_empty_source_nan():
    som = XPySom(4, 4, 8, random_seed=0)
    with pytest.warns(UserWarning, match="no rows"):
        assert np.isnan(som.quantization_error(_EmptySource()))
    with pytest.warns(UserWarning, match="no rows"):
        assert np.isnan(som.topographic_error(_EmptySource()))
    # predict's established empty behavior is unchanged
    assert som.predict(_EmptySource()).shape == (0,)


def test_built_instance_never_picks_up_later_env(monkeypatch):
    """Code-review r4: the _spec property rebuilds SomSpec per access, so
    a later env change must NOT leak into an already-built model (the
    'read ONCE at construction' contract). Guarded by the FROM_ENV
    sentinel: XPySom passes its resolved values, and a concrete
    bmu_tiles=None means 'the measured default table', not 'ask env'."""
    monkeypatch.delenv("XPYSOM_BMU_TILES", raising=False)
    monkeypatch.delenv("XPYSOM_BMU_PRECISION", raising=False)
    monkeypatch.delenv("XPYSOM_NO_PALLAS", raising=False)
    som = XPySom(4, 4, 8)
    assert som._spec.bmu_tiles is None
    # something elsewhere in the process exports the env pin...
    monkeypatch.setenv("XPYSOM_BMU_TILES", "16x128")
    monkeypatch.setenv("XPYSOM_BMU_PRECISION", "bf16")
    monkeypatch.setenv("XPYSOM_NO_PALLAS", "1")
    # ...and the already-built model is untouched on every access
    spec = som._spec
    assert spec.bmu_tiles is None
    assert spec.bmu_precision == "packed"
    assert spec.use_pallas is True
    # while a NEW model picks the env up (construction boundary)
    fresh = XPySom(4, 4, 8)
    # the env at THIS construction says 8x128: any other resolution (e.g.
    # a stale earlier value like (512, 1024)) is exactly the bug this
    # construction-boundary check exists for (round-5 review)
    assert fresh._spec.bmu_tiles == (16, 128)


def test_spec_concrete_values_validated_at_construction():
    """Code-review r4: concrete (non-env) spec values are validated and
    coerced at the config boundary — a list bmu_tiles must become a
    tuple (hashability), junk must raise immediately, not at first
    kernel trace or deep inside an lru_cache lookup."""
    spec = SomSpec(4, 4, 8, 2.0, 1.0, 0.5, 0.01, bmu_tiles=[512, 1024])
    assert spec.bmu_tiles == (512, 1024)
    hash(spec)  # hashable despite the list input
    spec2 = SomSpec(4, 4, 8, 2.0, 1.0, 0.5, 0.01, bmu_precision="BF16")
    assert spec2.bmu_precision == "bf16"
    with pytest.raises(ValueError, match="bmu_precision"):
        SomSpec(4, 4, 8, 2.0, 1.0, 0.5, 0.01, bmu_precision="float16")
    with pytest.raises(ValueError, match="bmu_tiles"):
        SomSpec(4, 4, 8, 2.0, 1.0, 0.5, 0.01, bmu_tiles=(7, 128))
    with pytest.raises(ValueError, match="bmu_tiles"):
        SomSpec(4, 4, 8, 2.0, 1.0, 0.5, 0.01, bmu_tiles="1024x2048")
