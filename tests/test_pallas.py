"""The fused BMU kernel (ops/pallas/bmu.py) in interpret mode on the CPU,
against float64 mirrors of its arithmetic; the dispatch that chooses it;
and the config validation around it. The compiled kernel is checked on the
card by tests_gpu/."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xpysom_dask_tpu.ops.pallas import bmu as pl_bmu


def _rp(a):
    """bf16 rounding as the kernel's call site does it, as float64."""
    return np.asarray(
        jax.lax.reduce_precision(jnp.asarray(a, jnp.float32), 8, 7), np.float64
    )


def _mirror(x, w, mode, cosine=False):
    """float64 distances of the problem the kernel solves in ``mode``:
    the bf16 operand layout of ``-2w`` (cosine: ``-ŵ`` with a zero
    per-node offset), products exact, sums in float64."""
    x = x.astype(np.float32)
    if cosine:
        n = np.linalg.norm(w.astype(np.float64), axis=1, keepdims=True)
        w = np.where(n > 0, w / np.where(n > 0, n, 1), 0).astype(np.float32)
        w = (0.5 * w).astype(np.float32)
    w2 = (-2.0 * w).astype(np.float32)
    wsq = np.zeros(len(w)) if cosine else (w.astype(np.float64) ** 2).sum(1)
    xh = _rp(x)
    xl = x.astype(np.float64) - xh
    wh = _rp(w2)
    if mode == "bf16":
        return xh @ wh.T + wsq
    if mode == "split2":
        xt = xh + _rp(xl)
        return xt @ wh.T + (wsq if cosine else 0.25 * (wh**2).sum(1))
    wl = w2.astype(np.float64) - wh
    return _rp(xl) @ wh.T + xh @ _rp(wl).T + xh @ wh.T + wsq


def _ambiguous(d, k=1, rel=1e-5):
    """Rows whose k+1 best DISTINCT values are within ``rel`` of the
    distance scale (exact duplicates are not ambiguous: first index)."""
    scale = np.abs(d).max() + 1.0
    out = np.zeros(len(d), bool)
    for i, row in enumerate(d):
        u = np.unique(row)[: k + 1]
        out[i] = (np.diff(u) < rel * scale).any()
    return out


def _problem(shape, seed=0):
    rng = np.random.RandomState(seed)
    if shape == "ragged":
        n, xy, d = 300, 333, 7
    elif shape == "tiny":
        n, xy, d = 64, 25, 3
    else:  # "ties": every node duplicated one node tile (128) or more later
        n, xy, d = 96, 300, 5
    x = rng.rand(n, d).astype(np.float32)
    w = rng.rand(xy, d).astype(np.float32)
    if shape == "ties":
        w[150:300] = w[0:150]
        x[:8] = w[3:11]  # rows whose best is an exact duplicate pair
    return x, w


@pytest.mark.parametrize("shape", ["ragged", "tiny", "ties"])
@pytest.mark.parametrize("top2", [False, True], ids=["top1", "top2"])
@pytest.mark.parametrize("mode", ["packed", "bf16", "split2"])
@pytest.mark.parametrize("activation", ["euclidean", "cosine"])
def test_kernel_matches_float64(activation, mode, top2, shape):
    x, w = _problem(shape)
    cosine = activation == "cosine"
    fn = pl_bmu.bmu_cosine if cosine else pl_bmu.bmu_euclidean
    outs = [np.asarray(o) for o in fn(
        jnp.asarray(x), jnp.asarray(w), mode=mode, top2=top2, interpret=True
    )]
    d = _mirror(x, w, mode, cosine)
    order = np.argsort(d, axis=1, kind="stable")
    ok = ~_ambiguous(d, 2 if top2 else 1)
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(outs[0][ok], order[ok, 0])
    if top2:
        np.testing.assert_array_equal(outs[2][ok], order[ok, 1])
    if not cosine:  # values: the partial squared distance
        rows = np.arange(len(x))
        np.testing.assert_allclose(
            outs[1], d[rows, outs[0]], rtol=1e-5, atol=1e-5
        )
    if shape == "ties":  # exact duplicates across node tiles: first index
        assert (outs[0][:8] == np.arange(3, 11)).all()
        if top2:
            assert (outs[2][:8] == np.arange(153, 161)).all()


@pytest.mark.parametrize(
    "n,xy,d",
    [
        (300, 333, 7),  # ragged everything (exercises padding)
        (256, 2048, 64),  # exact block fit
        (8, 25, 1),  # tiny 5x5x1 fixture shape
        (1000, 4100, 16),  # codebook just over a block multiple
    ],
)
def test_bmu_euclidean_matches_numpy(n, xy, d):
    rng = np.random.RandomState(0)
    x = rng.rand(n, d).astype(np.float32)
    w = rng.rand(xy, d).astype(np.float32)
    idx, val = pl_bmu.bmu_euclidean(jnp.asarray(x), jnp.asarray(w), interpret=True)
    dref = -2 * x.astype(np.float64) @ w.T.astype(np.float64) + (
        w.astype(np.float64) ** 2
    ).sum(1)
    np.testing.assert_array_equal(np.asarray(idx), dref.argmin(1))
    np.testing.assert_allclose(np.asarray(val), dref.min(1), rtol=1e-5, atol=1e-5)


def test_bmu_first_index_tie_breaking():
    # identical codebook rows: argmin must pick the first (NumPy semantics)
    x = np.array([[1.0, 2.0], [0.0, 0.0]], dtype=np.float32)
    w = np.tile(np.array([[1.0, 2.0]], dtype=np.float32), (7, 1))
    idx, _ = pl_bmu.bmu_euclidean(jnp.asarray(x), jnp.asarray(w), interpret=True)
    np.testing.assert_array_equal(np.asarray(idx), [0, 0])


def test_bmu_with_cached_wsq():
    rng = np.random.RandomState(1)
    x = rng.rand(64, 5).astype(np.float32)
    w = rng.rand(70, 5).astype(np.float32)
    wsq = (w**2).sum(1, keepdims=True).astype(np.float32)
    i1, v1 = pl_bmu.bmu_euclidean(jnp.asarray(x), jnp.asarray(w), interpret=True)
    i2, v2 = pl_bmu.bmu_euclidean(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(wsq), interpret=True
    )
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=1e-6)


@pytest.mark.parametrize("mode", ["packed", "split2", "bf16"])
def test_bmu_modes_agree(mode):
    rng = np.random.RandomState(5)
    x = rng.rand(200, 24).astype(np.float32)
    w = rng.rand(500, 24).astype(np.float32)
    idx, val = pl_bmu.bmu_euclidean(
        jnp.asarray(x), jnp.asarray(w), interpret=True, mode=mode
    )
    dref = -2 * x.astype(np.float64) @ w.T.astype(np.float64) + (
        w.astype(np.float64) ** 2
    ).sum(1)
    if mode == "packed":
        np.testing.assert_array_equal(np.asarray(idx), dref.argmin(1))
        np.testing.assert_allclose(np.asarray(val), dref.min(1), rtol=1e-4, atol=1e-4)
    else:
        # reduced-precision modes: near-tie flips, ~2^-8 values
        assert (np.asarray(idx) == dref.argmin(1)).mean() >= 0.95
        np.testing.assert_allclose(np.asarray(val), dref.min(1), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("d", [256, 512, 1024])
def test_bmu_wide_features(d, monkeypatch):
    """Per-width block table: features up to MAX_D stay on the kernel,
    wider ones take the XLA reference on the GPU; both match float64."""
    from xpysom_dask_tpu import core
    from xpysom_dask_tpu.ops.distances import DistanceFunction

    rng = np.random.RandomState(d)
    x = rng.rand(64, d).astype(np.float32)
    w = rng.rand(300, d).astype(np.float32)
    eucl = DistanceFunction("euclidean")
    monkeypatch.setattr(core.jax, "default_backend", lambda: "gpu")
    if d <= pl_bmu.MAX_D:
        assert core._pallas_bmu_kind(eucl, d) == "euclidean"
        idx, _ = pl_bmu.bmu_euclidean(
            jnp.asarray(x), jnp.asarray(w), interpret=True
        )
    else:
        assert core._pallas_bmu_kind(eucl, d) is None
        idx = core._bmu_chunk(eucl, jnp.asarray(x), jnp.asarray(w), None)
    dref = -2 * x.astype(np.float64) @ w.T.astype(np.float64) + (
        w.astype(np.float64) ** 2
    ).sum(1)
    np.testing.assert_array_equal(np.asarray(idx), dref.argmin(1))


def test_bmu_wider_than_max_d_raises():
    z = jnp.zeros((16, pl_bmu.MAX_D + 1), jnp.float32)
    with pytest.raises(ValueError, match="MAX_D"):
        pl_bmu.bmu_euclidean(z, z, interpret=True)


def test_bmu_centering_recovers_offset_fidelity():
    """The split modes' dropped terms scale with |x||w| (absolute), so
    offset, near-tied codebooks (a trained SOM over non-origin-centred
    features) can flip moderately-near ties. Centring by the codebook mean
    — translation-invariant for the argmin — must recover exact agreement
    with float64 (the dispatch centres by the midrange, the same idea)."""
    rng = np.random.RandomState(0)
    x = (rng.rand(1200, 8) * 4 + 10).astype(np.float32)
    w = (rng.rand(384, 8) * 4 + 10).astype(np.float32)
    w = 0.9 * w.mean(0) + 0.1 * w  # near-tied rows, like a smoothed codebook
    d64 = ((x[:, None].astype(np.float64) - w[None].astype(np.float64)) ** 2).sum(-1)
    ref = d64.argmin(1)
    c = jnp.mean(jnp.asarray(w), axis=0)
    idx, _ = pl_bmu.bmu_euclidean(
        jnp.asarray(x), jnp.asarray(w), mode="packed", interpret=True, center=c
    )
    np.testing.assert_array_equal(np.asarray(idx), ref)
    # idx must also be invariant to who computes wsq
    idx2, _ = pl_bmu.bmu_euclidean(
        jnp.asarray(x),
        jnp.asarray(w),
        jnp.sum(jnp.square(jnp.asarray(w)), axis=1, keepdims=True),
        mode="packed",
        interpret=True,
        center=c,
    )
    np.testing.assert_array_equal(np.asarray(idx2), ref)


def test_bmu_cosine_matches_float64():
    rng = np.random.RandomState(5)
    x = (rng.randn(120, 6) * 2).astype(np.float32)
    w = (rng.randn(260, 6) * 2).astype(np.float32)
    w[7] = 0.0  # zero codebook row: reference nan_to_num -> distance 1
    idx, val = pl_bmu.bmu_cosine(jnp.asarray(x), jnp.asarray(w), interpret=True)
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    den = np.linalg.norm(x64, axis=1, keepdims=True) * np.linalg.norm(w64, axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        ref = 1 - np.nan_to_num((x64 @ w64.T) / den)
    np.testing.assert_array_equal(np.asarray(idx), ref.argmin(1))
    np.testing.assert_allclose(np.asarray(val), ref.min(1), rtol=1e-4, atol=1e-5)


def test_bmu_cosine_zero_sample_row():
    # ||x||=0: every distance is 1 (reference convention) -> first index
    x = np.zeros((3, 4), np.float32)
    w = np.random.RandomState(0).rand(10, 4).astype(np.float32)
    idx, val = pl_bmu.bmu_cosine(jnp.asarray(x), jnp.asarray(w), interpret=True)
    np.testing.assert_array_equal(np.asarray(idx), np.zeros(3, np.int32))
    np.testing.assert_allclose(np.asarray(val), 1.0)


def test_bmu_top2_matches_stable_argsort():
    """top2=True returns the first two columns of a stable argsort of the
    float64 distance matrix (the reference's topographic_error selection,
    xpysom.py:731-734) — both indices, exact, across padding/tile
    shapes."""
    rng = np.random.RandomState(7)
    for n, xy, d in [(300, 333, 7), (256, 2048, 64), (64, 25, 3)]:
        x = rng.rand(n, d).astype(np.float32)
        w = rng.rand(xy, d).astype(np.float32)
        i1, v1, i2, v2 = pl_bmu.bmu_euclidean(
            jnp.asarray(x), jnp.asarray(w), interpret=True, top2=True
        )
        dref = -2 * x.astype(np.float64) @ w.T.astype(np.float64) + (
            w.astype(np.float64) ** 2
        ).sum(1)
        ref = np.argsort(dref, axis=1, kind="stable")[:, :2]
        np.testing.assert_array_equal(np.asarray(i1), ref[:, 0])
        np.testing.assert_array_equal(np.asarray(i2), ref[:, 1])
        np.testing.assert_allclose(
            np.asarray(v1), np.take_along_axis(dref, ref[:, :1], 1)[:, 0],
            rtol=1e-5, atol=1e-4,
        )
        np.testing.assert_allclose(
            np.asarray(v2), np.take_along_axis(dref, ref[:, 1:], 1)[:, 0],
            rtol=1e-5, atol=1e-4,
        )


def test_bmu_top2_duplicate_minimum_across_tiles():
    """A duplicate-valued minimum in a DIFFERENT node tile must come out
    as the second BMU (stable-argsort semantics), not be skipped by the
    winning-lane mask."""
    x = np.zeros((4, 3), np.float32)
    x[1] = 5
    w = np.zeros((2100, 3), np.float32)
    w[7] = 5
    w[1500] = 5  # identical best row, many node tiles away
    i1, _, i2, _ = pl_bmu.bmu_euclidean(
        jnp.asarray(x), jnp.asarray(w), interpret=True, top2=True
    )
    assert int(i1[1]) == 7 and int(i2[1]) == 1500
    # and within one tile
    w2 = np.zeros((200, 3), np.float32)
    w2[7] = 5
    w2[9] = 5
    i1, _, i2, _ = pl_bmu.bmu_euclidean(
        jnp.asarray(x), jnp.asarray(w2), interpret=True, top2=True
    )
    assert int(i1[1]) == 7 and int(i2[1]) == 9


@pytest.mark.parametrize("blocks", [(16, 16), (32, 64, 2, 2), (64, 128)])
def test_block_overrides_agree(blocks):
    """Any valid block shape computes the same winners (ties included)."""
    x, w = _problem("ties")
    ref = pl_bmu.bmu_euclidean(jnp.asarray(x), jnp.asarray(w), interpret=True)
    got = pl_bmu.bmu_euclidean(
        jnp.asarray(x), jnp.asarray(w), interpret=True, blocks=blocks
    )
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref[1]), rtol=1e-6)


def test_bmu_split2_exact_on_rounded_codebook():
    """split2's contract: the argmin/min of the partial distance from the
    16-BIT-TRUNCATED sample ``x̃ = f32(xh)+f32(xl)`` to the bf16-ROUNDED
    codebook, exact up to f32 accumulation — a perturbed problem, solved
    to accumulation accuracy. Oracle: float64 distances between x̃ and the
    codebook rounded the same way the kernel rounds it (bf16 split of
    -2·w)."""
    rng = np.random.RandomState(7)
    x = rng.rand(512, 24).astype(np.float32)
    w = rng.rand(700, 24).astype(np.float32)
    idx, val = pl_bmu.bmu_euclidean(
        jnp.asarray(x), jnp.asarray(w), interpret=True, mode="split2"
    )
    dref = _mirror(x, w, "split2")
    np.testing.assert_array_equal(np.asarray(idx), dref.argmin(1))
    np.testing.assert_allclose(np.asarray(val), dref.min(1), rtol=1e-4, atol=1e-4)


def test_bmu_split2_beats_bf16_on_offset_near_ties():
    """split2's flip error is the second-order 2(x−w)·(w−w_h) — on the
    offset near-tied regime it must flip far fewer winners than the bf16
    single-pass mode, raw and centred. It is NOT exact (the problem stays
    perturbed by the codebook rounding), which is why it is opt-in."""
    rng = np.random.RandomState(0)
    x = (rng.rand(1200, 8) * 4 + 10).astype(np.float32)
    w = (rng.rand(384, 8) * 4 + 10).astype(np.float32)
    w = 0.9 * w.mean(0) + 0.1 * w
    d64 = ((x[:, None].astype(np.float64) - w[None].astype(np.float64)) ** 2).sum(-1)
    ref = d64.argmin(1)

    def flips(mode, center=None):
        idx, _ = pl_bmu.bmu_euclidean(
            jnp.asarray(x), jnp.asarray(w), interpret=True, mode=mode,
            center=center,
        )
        return int((np.asarray(idx) != ref).sum())

    f_bf16 = flips("bf16")
    f_split2 = flips("split2")
    assert f_split2 < f_bf16 / 2, (f_split2, f_bf16)
    c = jnp.mean(jnp.asarray(w), axis=0)
    assert flips("split2", center=c) <= 8  # <0.7% on an adversarial fixture


def test_bmu_split2_shadow_coincidence_ties_first_index():
    """Two codebook rows whose bf16 shadows coincide are EXACT ties under
    split2 (its self-consistent ‖w_h‖² makes them tie — bf16 mode's exact
    norm term keeps them distinct), and the first-index tie-break then
    always elects the earlier row: why split2 warns at input_len < 32."""
    base = np.full((8,), 1.0, np.float32)
    w = np.stack([base, base + 1e-5, base * 1.5]).astype(np.float32)
    w2t_h = _rp(-2.0 * w)
    assert np.array_equal(w2t_h[0], w2t_h[1])
    x = np.tile(base + 1e-5, (16, 1)).astype(np.float32)
    d64 = ((x[:, None].astype(np.float64) - w[None].astype(np.float64)) ** 2).sum(-1)
    assert (d64.argmin(1) == 1).all()
    idx, _ = pl_bmu.bmu_euclidean(
        jnp.asarray(x), jnp.asarray(w), interpret=True, mode="split2"
    )
    assert (np.asarray(idx) == 0).all()


def test_split2_low_d_constructor_warns():
    from xpysom_dask_tpu import XPySom

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        XPySom(4, 4, 4, bmu_precision="split2")
    assert any("shadow" in str(r.message) for r in rec), [
        str(r.message) for r in rec
    ]
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        XPySom(4, 4, 64, bmu_precision="split2")
    assert not any("shadow" in str(r.message) for r in rec)


# -- dispatch: which path serves which search ---------------------------------


_ACTIVATIONS = [
    ("euclidean", {}, "euclidean"),
    ("cosine", {}, "cosine"),
    ("manhattan", {}, None),
    ("norm_p", {"p": 4}, None),
    ("norm_p", {"p": 3}, None),
    ("norm_p", {"p": 2.5}, None),
    ("euclidean_no_opt", {}, None),
]


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
@pytest.mark.parametrize(
    "name,kwargs,on_gpu", _ACTIVATIONS, ids=[f"{a[0]}{a[1]}" for a in _ACTIVATIONS]
)
def test_dispatch_by_backend_and_activation(monkeypatch, backend, name, kwargs, on_gpu):
    """The kernel serves euclidean and cosine on the GPU; the CPU and
    every other activation take the XLA reference."""
    from xpysom_dask_tpu import core
    from xpysom_dask_tpu.ops.distances import DistanceFunction

    monkeypatch.setattr(core.jax, "default_backend", lambda: backend)
    want = on_gpu if backend == "gpu" else None
    assert core._pallas_bmu_kind(DistanceFunction(name, kwargs), 64) == want


def test_pallas_bmu_kind_gating(monkeypatch):
    """Beyond the backend: the use_pallas switch, 'highest', the width
    limit, and the env kill switch resolved at spec construction."""
    from xpysom_dask_tpu import core
    from xpysom_dask_tpu.ops.distances import DistanceFunction

    monkeypatch.setattr(core.jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("XPYSOM_NO_PALLAS", raising=False)
    kind = core._pallas_bmu_kind
    eucl = DistanceFunction("euclidean")
    assert kind(eucl, 64) == "euclidean"
    assert kind(eucl, 64, use_pallas=False) is None
    assert kind(eucl, 64, mode="highest") is None
    assert kind(eucl, 64, mode="bf16") == "euclidean"
    assert kind(eucl, pl_bmu.MAX_D) == "euclidean"
    assert kind(eucl, pl_bmu.MAX_D + 1) is None
    monkeypatch.setenv("XPYSOM_NO_PALLAS", "1")
    spec = core.SomSpec(8, 8, 64, 2.0, 0.5, 0.5, 0.01)
    assert spec.use_pallas is False
    assert kind(eucl, 64, spec.use_pallas) is None
    assert kind(eucl, 64) == "euclidean"  # the gate itself reads no env


def test_backend_errors_propagate(monkeypatch):
    """A broken backend is an error, not a silent 'no kernel'."""
    from xpysom_dask_tpu import core
    from xpysom_dask_tpu.ops.distances import DistanceFunction

    def boom():
        raise RuntimeError("backend init failed")

    monkeypatch.setattr(core.jax, "default_backend", boom)
    with pytest.raises(RuntimeError, match="backend init failed"):
        core._pallas_bmu_kind(DistanceFunction("euclidean"), 64)


def test_training_through_kernel_matches_xla(monkeypatch):
    """The whole training path with the kernel forced in (interpret mode)
    gives the map of the XLA path, on the uniform-data fixture of
    test_training_parity (clustered data drives far nodes to near-equal
    weights, whose ties the two arithmetics break differently)."""
    import functools

    from xpysom_dask_tpu import XPySom, core

    data = np.random.RandomState(11).rand(200, 4).astype(np.float32)
    ref = XPySom(6, 5, 4, random_seed=42, use_pallas=False)
    ref.train(data, 5)
    monkeypatch.setattr(
        core, "_pallas_bmu_kind",
        lambda dist, d, use_pallas=None, mode=None: dist.name,
    )
    monkeypatch.setattr(
        pl_bmu, "searcher", functools.partial(pl_bmu.searcher, interpret=True)
    )
    core.clear_program_caches()
    try:
        som = XPySom(6, 5, 4, random_seed=42, n_parallel=128)
        som.train(data, 5)
        np.testing.assert_allclose(
            som.get_weights(), ref.get_weights(), rtol=1e-3, atol=1e-4
        )
        assert som.topographic_error(data) == pytest.approx(
            ref.topographic_error(data), abs=1e-9
        )
    finally:
        core.clear_program_caches()


# -- configuration --------------------------------------------------------------


@pytest.mark.parametrize("mode", ["split3", "margin", "f16", "HIGHEST_F64"])
def test_unknown_precision_raises(mode):
    from xpysom_dask_tpu import XPySom

    with pytest.raises(ValueError, match="bmu_precision"):
        XPySom(4, 4, 8, bmu_precision=mode)


def test_unknown_kernel_mode_raises():
    with pytest.raises(ValueError, match="mode="):
        pl_bmu.bmu_euclidean(
            jnp.zeros((8, 4)), jnp.zeros((16, 4)), interpret=True, mode="highest"
        )


@pytest.mark.parametrize(
    "blocks",
    [(1024, 100), (8, 128), (64,), (64, 128, 3, 2), (64, 128, 4, 0), "64x128"],
)
def test_invalid_blocks_raise(blocks):
    with pytest.raises(ValueError, match="bmu_tiles"):
        pl_bmu.validate_blocks(blocks)


def test_valid_blocks_normalised():
    assert pl_bmu.validate_blocks([64, 128]) == (64, 128)
    assert pl_bmu.validate_blocks((16, 16, 8, 4)) == (16, 16, 8, 4)
    assert pl_bmu.blocks_for(64) == pl_bmu._BLOCKS[64]
    assert pl_bmu.blocks_for(3) == pl_bmu._BLOCKS[16]
    assert pl_bmu.blocks_for(pl_bmu.MAX_D) == pl_bmu._BLOCKS[pl_bmu.MAX_D]


@pytest.mark.parametrize("d_pad", sorted(pl_bmu._BLOCKS))
@pytest.mark.parametrize("mode", ["packed", "split2", "bf16"])
def test_default_blocks_fit_shared_memory(d_pad, mode):
    """Every table row, in every mode, fits the shared-memory budget
    (the compiler refuses a block that does not), so _fit_smem leaves
    the packed rows as they were measured."""
    n_x, n_w = {"packed": (2, 2), "split2": (2, 1), "bf16": (1, 1)}[mode]
    bn, bj, warps, stages = pl_bmu._resolve_blocks(1 << 20, d_pad, None, n_x, n_w)
    assert pl_bmu._smem_bytes(bn, bj, stages, d_pad, n_x, n_w) <= pl_bmu._SMEM_BUDGET
    assert bn >= 16 and bj >= 16 and stages >= 1
    if mode == "packed":
        assert (bn, bj, warps, stages) == pl_bmu._BLOCKS[d_pad]


def test_fit_smem_shrinks_stages_then_tiles():
    # a block that was refused on the card: (128, 64, 4, 3) at D=512
    assert pl_bmu._smem_bytes(128, 64, 3, 512, 2, 2) == 655360
    bn, bj, stages = pl_bmu._fit_smem(128, 64, 3, 512, 2, 2)
    assert stages == 1 and pl_bmu._smem_bytes(bn, bj, stages, 512, 2, 2) <= pl_bmu._SMEM_BUDGET
    assert pl_bmu._fit_smem(64, 128, 3, 64, 2, 2) == (64, 128, 3)
