"""Benchmark: SOM batch-training throughput on the flagship workload.

Runs whole training epochs (fused BMU search + sufficient-statistics
update, on-device epoch loop) for the north-star configuration shape —
a 128×128 codebook over 64-dimensional fp32 samples (BASELINE.json) — on
the default JAX backend and prints two JSON lines, the BMU search rate
first and the headline training rate last:

    {"metric": "bmu_argmin_searches_per_sec", "value": ..., ...}
    {"metric": "som_batch_step_samples_per_sec_per_chip", "value": ...,
     "unit": "samples/s/chip", "vs_baseline": ...}

``vs_baseline``: the reference publishes no numbers, so the training
ratio is taken against the BASELINE.json north-star requirement expressed
per chip: 10^8 samples/epoch/min on a 64-chip slice = 10^8 / 64 / 60
≈ 26,042 samples/s/chip; the search ratio against 13.2 M searches/s.

Timing: every call ends in ``block_until_ready``. The training rate is a
two-depth slope — the same compiled ``train_fn`` timed at two epoch
depths, the time delta divided by the epoch delta — which cancels the
per-dispatch constant; the dispatch-inclusive number goes to stderr. The
search is timed through the dispatch training uses
(``core.bmu_searcher``). Any failure exits non-zero. The platform, device
kind and (on a GPU) the card's name and power limit go to stderr.
"""

import json
import os
import sys
import time

import numpy as np

NORTH_STAR_SAMPLES_PER_SEC_PER_CHIP = 1e8 / 64 / 60  # BASELINE.json north star

METRIC = "som_batch_step_samples_per_sec_per_chip"
UNIT = "samples/s/chip"

# Second metric: BMU argmin throughput at the flagship search shape (16384
# samples vs the 128×128 codebook, D=64, packed mode). The reference
# publishes no number; the anchor is a fixed 13.2 M searches/s, so the
# ratio tracks drift.
BMU_METRIC = "bmu_argmin_searches_per_sec"
BMU_UNIT = "searches/s"
BMU_BASELINE_SEARCHES_PER_SEC = 13.2e6


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from xpysom_dask_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from benchmarks.bench_utils import card, median_ms, repeated
    from xpysom_dask_tpu import core
    from xpysom_dask_tpu.core import SomSpec, chunk_data, make_train_fn

    # env overrides for smoke-testing on small hosts; driver runs defaults
    x = y = int(os.environ.get("XSOM_BENCH_XY", 128))
    d = int(os.environ.get("XSOM_BENCH_D", 64))
    n = int(os.environ.get("XSOM_BENCH_N", 1 << 19))
    chunk = int(os.environ.get("XSOM_BENCH_CHUNK", 16384))
    epochs_warmup = 1
    # Two-depth slope (module docstring): the deep depth is the env knob
    # (smoke tests shrink it); the shallow depth scales with it.
    epochs_hi = int(os.environ.get("XSOM_BENCH_EPOCHS", 35))
    epochs_lo = max(1, epochs_hi // 7)
    reps = 3

    spec = SomSpec(
        x=x,
        y=y,
        input_len=d,
        sigma=x / 2,
        sigmaN=1.0,
        learning_rate=0.5,
        learning_rateN=0.01,
    )
    # schedule length (static); we time fresh slices of it — sized so the
    # warmup + all timed reps always stay inside the schedule
    num_epochs = max(128, epochs_warmup + reps * (epochs_lo + epochs_hi))

    rng = np.random.RandomState(0)
    data_np = rng.rand(n, d).astype(np.float32)
    chunks, mask, _ = chunk_data(data_np, chunk)
    chunks = jnp.asarray(chunks)
    mask = jnp.asarray(mask)
    w = jnp.asarray(rng.rand(x, y, d).astype(np.float32))

    train_fn = make_train_fn(spec, num_epochs)

    dev = jax.devices()[0]
    print(
        f"platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())} workload: {x}x{y}x{d} SOM, N={n}, "
        f"chunk={chunk}",
        file=sys.stderr,
    )
    if dev.platform == "gpu":
        print(f"card: {card()}", file=sys.stderr)

    w = train_fn(w, chunks, mask, jnp.int32(0), jnp.int32(epochs_warmup))
    w.block_until_ready()

    # Alternate depths within one window; min-of-reps per depth. Each rep
    # times a fresh slice of the schedule, so decay math is real and the
    # compiled executable is the same object at both depths.
    t_min = {epochs_lo: float("inf"), epochs_hi: float("inf")}
    beg = epochs_warmup
    for _ in range(reps):
        for depth in (epochs_lo, epochs_hi):
            t0 = time.perf_counter()
            w = train_fn(
                w,
                chunks,
                mask,
                jnp.int32(beg),
                jnp.int32(beg + depth),
            )
            w.block_until_ready()
            t_min[depth] = min(t_min[depth], time.perf_counter() - t0)
            beg += depth

    direct = n * epochs_hi / t_min[epochs_hi]
    if epochs_hi > epochs_lo and t_min[epochs_hi] > t_min[epochs_lo]:
        per_epoch = (t_min[epochs_hi] - t_min[epochs_lo]) / (
            epochs_hi - epochs_lo
        )
        samples_per_sec = n / per_epoch
        method = "slope"
    else:
        # degenerate depths (smoke configs) or a window shift mid-run:
        # fall back to the dispatch-inclusive estimate
        samples_per_sec = direct
        method = "direct"

    print(
        f"t(lo={epochs_lo})={t_min[epochs_lo]:.3f}s "
        f"t(hi={epochs_hi})={t_min[epochs_hi]:.3f}s -> "
        f"{samples_per_sec:,.0f} samples/s/chip [{method}] "
        f"(dispatch-inclusive {direct:,.0f})",
        file=sys.stderr,
    )

    # ---- metric 2: BMU argmin throughput (emitted BEFORE the headline
    # training metric — the last line is the headline), through the
    # search training dispatches, on the just-trained codebook; indices
    # only, the training-path contract
    sn = int(os.environ.get("XSOM_BENCH_SEARCH_N", 16384))
    inner = int(os.environ.get("XSOM_BENCH_SEARCH_INNER", 10))
    sx = jnp.asarray(rng.rand(sn, d).astype(np.float32))
    search = core.bmu_searcher(spec.distance_fn(), w.reshape(x * y, d), None, spec)
    per_exec = median_ms(repeated(search, inner), sx, reps=5) / inner / 1e3
    searches_per_sec = sn / per_exec
    print(
        f"BMU search: {sn}x{x * y}x{d} per_exec={per_exec * 1e3:.3f} ms "
        f"-> {searches_per_sec:,.0f} searches/s",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": BMU_METRIC,
                "value": round(searches_per_sec, 1),
                "unit": BMU_UNIT,
                "vs_baseline": round(
                    searches_per_sec / BMU_BASELINE_SEARCHES_PER_SEC, 3
                ),
            }
        )
    )

    print(
        json.dumps(
            {
                "metric": METRIC,
                "value": round(samples_per_sec, 1),
                "unit": UNIT,
                "vs_baseline": round(
                    samples_per_sec / NORTH_STAR_SAMPLES_PER_SEC_PER_CHIP, 3
                ),
            }
        )
    )


if __name__ == "__main__":
    main()
