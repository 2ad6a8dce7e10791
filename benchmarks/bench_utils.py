"""Benchmark harness utilities.

Rebuild of the reference harness (``benchmarks/bench_utils.py``): warmup +
repeat timing with mean/std/min/max, plus input generators. Differences by
design (documented reference bugs not reproduced, SURVEY.md §7):

- timing synchronizes with ``jax.block_until_ready`` instead of CUDA
  events; the reference's ``time_np`` touched an undefined CUDA event
  when CuPy was absent (reference bench_utils.py:25);
- generators return float32 (the dtype the library computes in).

``card()``, ``clustered`` and ``repeated``/``median_ms`` serve the
on-card scripts (``chip_smoke.py``, ``benchmarks/bmu_blocks.py``,
``benchmarks/epoch_chunks.py``).
"""

from __future__ import annotations

import statistics
import subprocess
import time
from dataclasses import dataclass

import numpy as np

import jax

__all__ = [
    "bench",
    "BenchResult",
    "rand_samples",
    "rand_codebook",
    "clustered",
    "card",
    "repeated",
    "median_ms",
]


@dataclass
class BenchResult:
    name: str
    mean: float
    std: float
    min: float
    max: float
    reps: int

    def __str__(self):
        return (
            f"{self.name}: mean={self.mean*1e3:.3f}ms std={self.std*1e3:.3f}ms "
            f"min={self.min*1e3:.3f}ms max={self.max*1e3:.3f}ms (n={self.reps})"
        )


def _sync(result):
    jax.block_until_ready(result)


def bench(fn, *args, name="bench", reps=10, warmup=2) -> BenchResult:
    """Time ``fn(*args)`` with warmup; synchronizes on every rep."""
    for _ in range(warmup):
        _sync(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    arr = np.asarray(times)
    return BenchResult(
        name=name,
        mean=float(arr.mean()),
        std=float(arr.std()),
        min=float(arr.min()),
        max=float(arr.max()),
        reps=reps,
    )


def rand_samples(n, d, seed=0):
    return np.random.RandomState(seed).rand(n, d).astype(np.float32)


def rand_codebook(x, y, d, seed=1):
    return np.random.RandomState(seed).rand(x, y, d).astype(np.float32)


def clustered(n, d, seed):
    """``n`` float32 rows around 64 random centres in [0, 1)^d (σ = 0.05):
    the flagship's training data."""
    rng = np.random.default_rng(seed)
    centres = rng.random((64, d), dtype=np.float32)
    rows = centres[rng.integers(0, 64, n)]
    rows += 0.05 * rng.standard_normal((n, d), dtype=np.float32)
    return rows


def card() -> str:
    """``name, power.limit`` of the first GPU as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints it (a card below its maximum power limit runs slower under
    load, so every number is kept beside this line)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def repeated(search, inner):
    """jit of ``inner`` chained ``search(x)`` calls returning a scalar:
    each input depends on the previous result, so XLA cannot hoist the
    search out of the loop, and one dispatch amortises launch overhead."""
    import jax.numpy as jnp

    @jax.jit
    def run(x):
        def body(_, acc):
            idx = search(x + acc)[0]
            return acc + 0.0 * idx[0].astype(jnp.float32)

        return jax.lax.fori_loop(0, inner, body, jnp.float32(0.0))

    return run


def median_ms(fn, *args, reps=7):
    """Median wall time of ``fn(*args)`` in ms after one warm-up call
    (compilation), each call ending in ``block_until_ready``."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3
