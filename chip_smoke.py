"""Smoke run of the SOM training path on one GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py            # one card: phases 1-5
    python chip_smoke.py --four     # four cards: the mesh comparisons only

Phases (one process; any failure exits non-zero):

1. device — platform, device kind and count, the card's name and power
   limit; anything but a GPU fails;
2. kernel vs XLA — the fused BMU kernel and the XLA reference at the
   flagship search (16384 samples × 16384 nodes × 64) against float64 on
   4096 rows, then timed in turns (XLA, kernel, kernel, XLA): the search,
   and one flagship epoch through ``make_train_fn`` with
   ``use_pallas=True`` / ``False``;
3. golden parity — 16×16×8 maps (rect and hex) against the float64
   golden model at the CPU suite's tolerances;
4. flagship — ``XPySom(128, 128, 64, sigma=64)`` trained 3 epochs on 2²²
   resident clustered samples, evaluated on 2²⁰ of them, then a 2-epoch
   ``FileSource`` run over 2²¹ rows that must equal the resident run on
   them (rtol 1e-4, free-running and epoch by epoch); a repeated
   resident run must be bit-identical;
5. on-card tests — ``tests_gpu`` (marker ``gpu``) through ``pytest.main``.

``--four`` instead trains the flagship with ``mesh=4`` against
``mesh=None`` and a 512×512×64 map on ``make_grid_mesh(2, 2)`` against
one device: epoch by epoch at rtol 1e-4, and free-running with the
quantization errors within 1e-3.

The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}`` on success, ``{"ok": false, ...}`` on
failure. Data is generated from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")  # the streamed rows

FLAGSHIP = dict(x=128, y=128, d=64, sigma=64.0)
N_RESIDENT = 1 << 22
N_EVAL = 1 << 20
N_STREAM = 1 << 21
SEARCH = (16384, 16384, 64)  # samples, nodes, features
CHECK_ROWS = 4096
NEAR_TIE = 1e-6  # relative float64 gap under which winners may differ


def log(msg=""):
    print(msg, flush=True)


def lockstep(a, b, data_a, data_b, epochs, label):
    """Train SOMs ``a`` and ``b`` epoch by epoch from the SAME codebook
    (``b`` restarts from ``a``'s weights each epoch) and require each
    epoch's weights to agree at rtol 1e-4: every epoch of the path under
    test (streaming, sharding) is checked on its own, apart from how a
    last-bit difference in one epoch's sums may grow over later ones."""
    import numpy as np

    worst = 0.0
    for t in range(epochs):
        b._weights = a.get_weights().copy()
        a.train(data_a, epochs, iter_beg=t, iter_end=t + 1)
        b.train(data_b, epochs, iter_beg=t, iter_end=t + 1)
        wa, wb = a.get_weights(), b.get_weights()
        worst = max(worst, float(np.abs(wa - wb).max()))
        np.testing.assert_allclose(wb, wa, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{label}, epoch {t}")
    log(f"{label}: {epochs} epochs in lockstep agree at rtol 1e-4 "
        f"(max |dW| {worst:.2e})")


def free_running(a, b, data, epochs, label, qe_rtol):
    """Train ``a`` and ``b`` ``epochs`` epochs each on their own and
    require their quantization errors on the first N_EVAL rows to agree
    within ``qe_rtol``. For paths whose sums are added in another order
    (a psum over devices), so that near-tied winners may flip in later
    epochs and the weights may not agree to rtol 1e-4."""
    import numpy as np

    a.train(data, epochs)
    b.train(data, epochs)
    qa = a.quantization_error(data[:N_EVAL])
    qb = b.quantization_error(data[:N_EVAL])
    dw = float(np.abs(a.get_weights() - b.get_weights()).max())
    log(f"{label}, free-running {epochs} epochs: QE {qa:.6f} vs {qb:.6f} "
        f"(rel {abs(qa - qb) / qa:.2e}, limit {qe_rtol}), max |dW| {dw:.2e}")
    assert abs(qa - qb) / qa < qe_rtol, f"{label}: QE differs"


def phase_device():
    import jax

    from benchmarks.bench_utils import card

    devs = jax.devices()
    dev = devs[0]
    log(f"platform={dev.platform} kind={dev.device_kind} count={len(devs)}")
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's default platform is {dev.platform}")
    log(f"card: {card()}")
    return {"platform": dev.platform, "kind": dev.device_kind, "count": len(devs)}


def _near_tie(d64, k):
    """Rows whose order among the k+1 nearest nodes has a relative float64
    gap below NEAR_TIE (d64: full squared distances)."""
    import numpy as np

    s = np.sort(d64, axis=1)[:, : k + 1]
    gaps = np.diff(s, axis=1) / np.maximum(s[:, 1:], 1e-30)
    return (gaps < NEAR_TIE).any(axis=1)


def phase_kernel_vs_xla(seed):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from benchmarks.bench_utils import clustered, median_ms, repeated
    from xpysom_dask_tpu import core
    from xpysom_dask_tpu.ops.distances import DistanceFunction
    from xpysom_dask_tpu.utils.hw import default_n_parallel

    n, xy, d = SEARCH
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.random((n, d), dtype=np.float32))
    w = jnp.asarray(rng.random((xy, d), dtype=np.float32))
    eucl = DistanceFunction("euclidean")

    def spec(**kw):
        return core.SomSpec(128, 128, d, 64.0, 1.0, 0.5, 0.01, **kw)

    def searcher(top2=False, **kw):
        return core.bmu_searcher(eucl, w, None, spec(**kw), top2=top2)

    assert core._pallas_bmu_kind(eucl, d) == "euclidean", "kernel not chosen"

    # correctness at the real width against float64
    xc = np.asarray(x[:CHECK_ROWS], np.float64)
    w64 = np.asarray(w, np.float64)
    d64 = (xc**2).sum(1)[:, None] - 2 * xc @ w64.T + (w64**2).sum(1)
    ref = d64.argmin(1)
    tie1, tie2 = _near_tie(d64, 1), _near_tie(d64, 2)
    log(f"float64 near-ties (rel gap < {NEAR_TIE}): top1 {int(tie1.sum())}, "
        f"top2 {int(tie2.sum())} of {CHECK_ROWS} rows")

    def winners(s):
        return tuple(np.asarray(o) for o in jax.jit(s)(x[:CHECK_ROWS]))

    for name, kw in (("kernel packed", {}), ("xla", {"use_pallas": False})):
        idx = winners(searcher(**kw))[0]
        bad = int(((idx != ref) & ~tie1).sum())
        log(f"{name}: disagreements vs float64 {int((idx != ref).sum())}, "
            f"outside near-ties {bad}")
        assert bad == 0, f"{name} disagrees with float64 outside near-ties"
    idx = winners(searcher(bmu_precision="bf16"))[0]
    qe64 = np.mean(np.sqrt(np.maximum(d64[np.arange(CHECK_ROWS), ref], 0)))
    qe16 = np.mean(np.sqrt(np.maximum(d64[np.arange(CHECK_ROWS), idx], 0)))
    gap = abs(qe16 - qe64) / qe64
    log(f"kernel bf16: flip rate {float(np.mean(idx != ref)):.5f}, "
        f"QE rel gap vs float64 {gap:.3e} (limit 1e-4)")
    assert gap < 1e-4, "bf16 QE gap"
    i1, _, i2, _ = winners(searcher(top2=True))
    order = np.argsort(d64, axis=1, kind="stable")[:, :2]
    bad = int(((i1 != order[:, 0]) | (i2 != order[:, 1]))[~tie2].sum())
    log(f"kernel top2 vs stable argsort: disagreements outside near-ties {bad}")
    assert bad == 0, "top2 disagrees with a stable argsort"

    # timing in turns: XLA, kernel, kernel, XLA
    inner = 10
    runs = {
        "xla": repeated(searcher(use_pallas=False), inner),
        "kernel": repeated(searcher(), inner),
    }
    search_ms = {"xla": [], "kernel": []}
    for arm in ("xla", "kernel", "kernel", "xla"):
        search_ms[arm].append(median_ms(runs[arm], x) / inner)
    log(f"search {n}x{xy}x{d} ms per search, in turns: "
        f"xla {search_ms['xla']}, kernel {search_ms['kernel']}")

    data = clustered(N_RESIDENT, d, seed + 1)
    w0 = jnp.asarray(np.random.default_rng(seed + 2).random(
        (128, 128, d), dtype=np.float32))
    arms = {}
    for name, use_pallas in (("xla", False), ("kernel", True)):
        sp = spec(use_pallas=use_pallas)
        chunk = default_n_parallel(
            128 * 128, fused=core._pallas_bmu_kind(
                eucl, d, use_pallas) is not None,
        )
        chunks, mask, _ = core.chunk_data(data, chunk)
        arms[name] = (core.make_train_fn(sp, 10), jnp.asarray(chunks),
                      jnp.asarray(mask), chunk)
        fn, c, m, _ = arms[name]
        jax.block_until_ready(fn(jnp.copy(w0), c, m, 0, 1))  # compile
    epoch_ms = {"xla": [], "kernel": []}
    for t, arm in enumerate(("xla", "kernel", "kernel", "xla")):
        fn, c, m, _ = arms[arm]
        w = jax.block_until_ready(jnp.copy(w0))  # the codebook is donated
        t0 = time.perf_counter()
        jax.block_until_ready(fn(w, c, m, t, t + 1))
        epoch_ms[arm].append((time.perf_counter() - t0) * 1e3)
    log(f"flagship epoch (N={N_RESIDENT}, 128x128x64) ms, in turns: "
        f"xla {epoch_ms['xla']} (chunk {arms['xla'][3]}), "
        f"kernel {epoch_ms['kernel']} (chunk {arms['kernel'][3]})")
    faster = max(epoch_ms["kernel"]) < min(epoch_ms["xla"])
    log(f"kernel faster end to end: {faster} "
        f"(xla/kernel epoch ratio {min(epoch_ms['xla']) / max(epoch_ms['kernel']):.2f})")
    del arms, data


def phase_golden(seed):
    """tests/test_training_parity.py's configuration (6×5×4, 200 rows, 5
    epochs) at its tolerances, and 12×12×16 (σ=3) on 4096 rows: one
    epoch's weights at the same tolerances, the 5-epoch QE within 5e-4
    (float32 against float64 BMU near-ties compound over epochs at this
    size, on the CPU's exact XLA path too)."""
    import numpy as np

    from xpysom_dask_tpu import XPySom
    from xpysom_dask_tpu.models.golden import GoldenSom

    small = np.random.RandomState(11).rand(200, 4).astype(np.float32)
    big = np.random.default_rng(seed).random((4096, 16), dtype=np.float32)
    for topology in ("rectangular", "hexagonal"):
        for (x, y, d), data, tight, sigma in (
            ((6, 5, 4), small, 5, 0), ((12, 12, 16), big, 1, 3.0)
        ):
            kw = dict(sigma=sigma, topology=topology, random_seed=42)
            ours = XPySom(x, y, d, **kw)
            gold = GoldenSom(x, y, d, **kw)
            np.testing.assert_array_equal(ours._weights, gold.weights)
            ours.train(data, 5, iter_end=tight)
            gold.train(data, 5, iter_end=tight)
            dw = float(np.abs(ours._weights - gold.weights).max())
            np.testing.assert_allclose(
                ours._weights, gold.weights, rtol=1e-3, atol=1e-4
            )
            if tight < 5:
                ours.train(data, 5, iter_beg=tight)
                gold.train(data, 5, iter_beg=tight)
            qe, qe_g = ours.quantization_error(data), gold.quantization_error(data)
            if tight == 5:
                np.testing.assert_allclose(qe, qe_g, rtol=1e-5, atol=1e-6)
            else:
                assert abs(qe - qe_g) / qe_g < 5e-4, (qe, qe_g)
            log(f"golden parity {topology} {x}x{y}x{d} on {len(data)} rows: "
                f"max |dW| after {tight} epoch(s) {dw:.2e}, "
                f"QE after 5 epochs {qe:.6f} vs {qe_g:.6f}")


def phase_flagship(seed):
    import jax
    import numpy as np

    from benchmarks.bench_utils import clustered
    from xpysom_dask_tpu import XPySom
    from xpysom_dask_tpu.parallel.pipeline import FileSource
    from xpysom_dask_tpu.utils.native import native_available

    x, y, d, sigma = (FLAGSHIP[k] for k in ("x", "y", "d", "sigma"))
    data = clustered(N_RESIDENT, d, seed)
    ev = data[:N_EVAL]
    som = XPySom(x, y, d, sigma=sigma, random_seed=seed)
    qe0 = som.quantization_error(ev)
    t0 = time.perf_counter()
    som.train(data, 3, iter_end=1)
    t1 = time.perf_counter()
    som.train(data, 3, iter_beg=1)
    t2 = time.perf_counter()
    log(f"flagship train: epoch 1 (compile + upload + epoch) {t1 - t0:.3f} s; "
        f"epochs 2-3 {(t2 - t1) / 2 * 1e3:.1f} ms per epoch "
        f"(incl. that call's upload of {data.nbytes >> 20} MiB)")
    w = som.get_weights()
    assert np.isfinite(w).all(), "non-finite weights"
    qe1 = som.quantization_error(ev)
    te = som.topographic_error(ev)
    wins = som.winner(ev)
    um = som.distance_map()
    assert len(wins) == N_EVAL and all(0 <= a < x and 0 <= b < y for a, b in wins[:1000])
    assert np.isfinite([qe0, qe1, te]).all() and 0 <= te <= 1
    assert um.shape == (x, y) and np.isfinite(um).all()
    log(f"flagship eval on {N_EVAL} rows: QE {qe0:.4f} -> {qe1:.4f} "
        f"({qe0 / qe1:.2f}x), TE {te:.4f}, distance_map max {float(um.max()):.3f}")
    assert qe0 / qe1 >= 3, "QE fell by less than 3x"
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")

    made = not os.path.isdir(OUT_DIR)
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "stream.f32")
    rows = data[:N_STREAM]
    rows.tofile(path)
    del data, ev
    try:
        src = FileSource(path, N_STREAM, d)
        streamed = XPySom(x, y, d, sigma=sigma, random_seed=seed)
        t0 = time.perf_counter()
        streamed.train(src, 2)
        dt = time.perf_counter() - t0
        loader = "native chunk loader" if native_available() else "NumPy memmap"
        log(f"streamed {N_STREAM} rows x 2 epochs from disk via {loader}: "
            f"{dt:.2f} s incl. compile")
        resident = XPySom(x, y, d, sigma=sigma, random_seed=seed)
        resident.train(rows, 2)
        again = XPySom(x, y, d, sigma=sigma, random_seed=seed)
        again.train(rows, 2)
        ws, wr, wa = (s.get_weights() for s in (streamed, resident, again))
        log(f"resident run repeated: max |dW| {float(np.abs(wa - wr).max()):.2e}, "
            f"bit-identical {np.array_equal(wa, wr)}")
        log(f"streamed vs resident, free-running 2 epochs: max |dW| "
            f"{float(np.abs(ws - wr).max()):.2e}, bit-identical "
            f"{np.array_equal(ws, wr)} (limit rtol 1e-4)")
        assert np.array_equal(wa, wr), "a repeated resident run differs"
        np.testing.assert_allclose(ws, wr, rtol=1e-4, atol=1e-6,
                                   err_msg="streamed vs resident")
        lockstep(
            XPySom(x, y, d, sigma=sigma, random_seed=seed),
            XPySom(x, y, d, sigma=sigma, random_seed=seed),
            rows, src, 2, "streamed == resident",
        )
    finally:
        os.remove(path)
        if made:
            os.rmdir(OUT_DIR)


def phase_tests():
    import pytest

    class Tally:
        def __init__(self):
            self.counts = {"passed": 0, "failed": 0, "skipped": 0}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.counts[report.outcome] += 1

    tally = Tally()
    rc = pytest.main(
        [os.path.join(REPO, "tests_gpu"), "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "--rootdir", REPO],
        plugins=[tally],
    )
    log(f"tests_gpu: {tally.counts} (pytest exit {int(rc)})")
    assert rc == 0 and tally.counts["skipped"] == 0 and tally.counts["passed"] > 0


def phase_four(seed):
    import jax

    from benchmarks.bench_utils import clustered
    from xpysom_dask_tpu import XPySom
    from xpysom_dask_tpu.parallel.grid_sharded import make_grid_mesh

    assert len(jax.devices()) >= 4, f"--four needs 4 devices, have {len(jax.devices())}"
    x, y, d, sigma = (FLAGSHIP[k] for k in ("x", "y", "d", "sigma"))
    data = clustered(N_RESIDENT, d, seed)
    t0 = time.perf_counter()
    label = "flagship mesh=4 vs mesh=None"
    lockstep(
        XPySom(x, y, d, sigma=sigma, random_seed=seed),
        XPySom(x, y, d, sigma=sigma, random_seed=seed, mesh=4),
        data, data, 3, label,
    )
    free_running(
        XPySom(x, y, d, sigma=sigma, random_seed=seed),
        XPySom(x, y, d, sigma=sigma, random_seed=seed, mesh=4),
        data, 3, label, 1e-3,
    )
    log(f"({time.perf_counter() - t0:.1f} s incl. compile and uploads)")
    del data

    n = 1 << 18
    data = clustered(n, d, seed + 3)
    t0 = time.perf_counter()
    label = f"512x512x64 on {n} rows, grid 2x2 vs one device"

    def pair():
        return (
            XPySom(512, 512, d, sigma=256.0, random_seed=seed),
            XPySom(512, 512, d, sigma=256.0, random_seed=seed,
                   mesh=make_grid_mesh(2, 2)),
        )

    lockstep(*pair(), data, data, 2, label)
    free_running(*pair(), data, 2, label, 1e-3)
    log(f"({time.perf_counter() - t0:.1f} s incl. compile and uploads)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh comparisons")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    phase = "setup"
    try:
        sys.path.insert(0, REPO)
        from xpysom_dask_tpu.utils.compile_cache import enable_compile_cache

        log(f"compile cache: {enable_compile_cache(REPO)}")
        phase = "device"
        device = phase_device()
        if args.four:
            phase = "four"
            phase_four(args.seed)
        else:
            for phase, run in (
                ("kernel_vs_xla", lambda: phase_kernel_vs_xla(args.seed)),
                ("golden", lambda: phase_golden(args.seed)),
                ("flagship", lambda: phase_flagship(args.seed)),
                ("tests_gpu", phase_tests),
            ):
                t0 = time.perf_counter()
                log(f"== phase {phase}")
                run()
                log(f"== phase {phase} ok ({time.perf_counter() - t0:.1f} s)")
    except BaseException as e:  # report which phase failed, then fail
        traceback.print_exc()
        print(json.dumps({"ok": False, "phase": phase,
                          "error": f"{type(e).__name__}: {e}"[:300]}), flush=True)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
