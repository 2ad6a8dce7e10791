"""Tracing / profiling hooks.

The reference has no tracer — only the ETA progress bar and manual
benchmark CLIs (SURVEY.md §5 "Tracing / profiling"). The equivalents
here:

- ``trace(dir)``: context manager around ``jax.profiler`` producing a
  TensorBoard-viewable device trace of whatever runs inside (e.g. a
  training call);
- ``annotate(name)``: ``TraceAnnotation`` wrapper so epoch/superbatch
  boundaries show up as named spans in the trace;
- ``EpochTimer``: lightweight host-side per-epoch wall-clock collector
  (mean/std/last), usable as the ``progress`` callback of the streaming
  pipeline;
- ``epoch_anatomy``: two-depth slope decomposition of one training epoch
  into BMU / scatter / update stage costs.
"""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["trace", "annotate", "EpochTimer", "epoch_anatomy"]


@contextlib.contextmanager
def trace(log_dir):
    """Capture a device profile into ``log_dir`` (TensorBoard format)."""
    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span visible in profiler traces."""
    return jax.profiler.TraceAnnotation(name)


class EpochTimer:
    """Host-side per-epoch timing; call ``tick()`` (or use as the pipeline
    ``progress`` callback) once per epoch."""

    def __init__(self):
        self._last = time.perf_counter()
        self.durations = []

    def tick(self, _epoch=None):
        now = time.perf_counter()
        self.durations.append(now - self._last)
        self._last = now

    __call__ = tick

    @property
    def mean(self):
        return sum(self.durations) / len(self.durations) if self.durations else 0.0

    def summary(self) -> str:
        if not self.durations:
            return "no epochs recorded"
        import statistics

        std = statistics.pstdev(self.durations) if len(self.durations) > 1 else 0.0
        return (
            f"{len(self.durations)} epochs: mean={self.mean*1e3:.1f}ms "
            f"std={std*1e3:.1f}ms last={self.durations[-1]*1e3:.1f}ms"
        )


def epoch_anatomy(som, data, *, lo=2, hi=8, reps=3):
    """Decompose one training epoch of ``som`` over ``data`` into
    slope-clean per-stage costs, measured in ONE window:

    - ``bmu_ms``   — the BMU-search scan alone,
    - ``stats_ms`` — BMU + sufficient-statistics scatter,
    - ``epoch_ms`` — the full epoch step (incl. neighborhood update);
    - derived: ``scatter_ms = stats - bmu``, ``update_ms = epoch - stats``.

    Method: each stage runs as a jitted ``lax.scan`` of ``inner`` chained
    repetitions; timing the same executable at two inner depths and
    dividing the time delta by the depth delta cancels the per-dispatch
    constant (launch and host overhead) that plain per-call timing folds
    into the result. Each call ends in ``block_until_ready``.

    Single-device measurement (``som`` may carry a mesh for training;
    anatomy runs the unsharded step — per-shard anatomy is the same
    program at 1/shards the data). Returns a dict of milliseconds plus
    the method descriptor."""
    import numpy as np
    import jax.numpy as jnp

    from .. import core
    from ..core import chunk_data

    spec = som._spec
    dist = spec.distance_fn()
    xy = spec.xy
    data2d = np.ascontiguousarray(np.atleast_2d(data), dtype=np.float32)
    chunks, mask, _ = chunk_data(data2d, som._n_parallel)
    chunks = jnp.asarray(chunks)
    mask = jnp.asarray(mask)
    w = jnp.asarray(np.asarray(som._weights, dtype=np.float32))
    num_epochs = 8  # static schedule for the traced decays

    def bmu_only(wp, cks, msk):
        w_flat = wp.reshape(xy, spec.input_len)
        w_sq = (
            jnp.sum(jnp.square(w_flat), axis=1, keepdims=True)
            if dist.can_cache
            else None
        )

        def body(c, xs):
            xch, _ = xs
            bmu = core._bmu_chunk(dist, xch, w_flat, w_sq, spec)
            return c + jnp.sum(bmu.astype(jnp.float32)), None

        z, _ = jax.lax.scan(body, jnp.float32(0.0), (cks, msk))
        return z

    def stats_only(wp, cks, msk):
        w_flat = wp.reshape(xy, spec.input_len)
        w_sq = (
            jnp.sum(jnp.square(w_flat), axis=1, keepdims=True)
            if dist.can_cache
            else None
        )
        s, cnt = core._accumulate_stats(dist, w_flat, w_sq, cks, msk, xy, spec)
        return jnp.sum(s) + jnp.sum(cnt)

    def full_epoch(wp, cks, msk):
        w_flat = wp.reshape(xy, spec.input_len)
        w_sq = (
            jnp.sum(jnp.square(w_flat), axis=1, keepdims=True)
            if dist.can_cache
            else None
        )
        eta, sig = core._decays(spec, jnp.int32(3), num_epochs)
        s, cnt = core._accumulate_stats(dist, w_flat, w_sq, cks, msk, xy, spec)
        new_flat = core._update_from_stats(spec, w_flat, s, cnt, eta, sig)
        return jnp.sum(new_flat)

    def scanned(component, inner):
        @jax.jit
        def run(wp, cks, msk):
            def body(c, _):
                z = component(wp * (1.0 + c), cks, msk)
                return jnp.float32(1e-30) * jnp.tanh(z), None

            c, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=inner)
            return c

        return run

    out = {}
    for name, comp in (
        ("bmu", bmu_only),
        ("stats", stats_only),
        ("epoch", full_epoch),
    ):
        t_min = {}
        runs = {depth: scanned(comp, depth) for depth in (lo, hi)}
        for depth, run in runs.items():
            run(w, chunks, mask).block_until_ready()  # compile + warmup
        for depth in (lo, hi):
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                runs[depth](w, chunks, mask).block_until_ready()
                best = min(best, time.perf_counter() - t0)
            t_min[depth] = best
        if hi > lo and t_min[hi] > t_min[lo]:
            per = (t_min[hi] - t_min[lo]) / (hi - lo)
            method = f"slope({lo},{hi})x{reps}"
        else:  # degenerate window: dispatch-inclusive fallback
            per = t_min[hi] / hi
            method = "direct"
        out[f"{name}_ms"] = per * 1e3
        out[f"{name}_method"] = method
    out["scatter_ms"] = out["stats_ms"] - out["bmu_ms"]
    out["update_ms"] = out["epoch_ms"] - out["stats_ms"]
    return out
