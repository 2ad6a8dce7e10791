#!/usr/bin/env python
"""Distance-kernel benchmark CLI.

Mirror of the reference CLI (``benchmarks/bench_distances.py``: defaults
n=10000 samples, 256 codebook rows, 100 dims, 10 reps — bench_distances.py:18-22)
with its stale ``import xpysom.distances`` fixed to import this package.
"""

import argparse
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")  # allow running from the repo root

from xpysom_dask_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from benchmarks.bench_utils import bench, rand_samples  # noqa: E402
from xpysom_dask_tpu.ops import distances as D  # noqa: E402

CASES = {
    "euclidean": lambda x, w: D.euclidean_squared_distance_part(x, w),
    "euclidean_no_opt": lambda x, w: D.euclidean_squared_distance(x, w),
    "euclidean_full": lambda x, w: D.euclidean_distance(x, w),
    "cosine": lambda x, w: D.cosine_distance(x, w),
    "manhattan": lambda x, w: D.manhattan_distance(x, w),
    "manhattan_no_opt": lambda x, w: D.manhattan_distance_no_opt(x, w),
    "norm_p_2": lambda x, w: D.norm_p_power_distance(x, w, p=2),
    "norm_p_3": lambda x, w: D.norm_p_power_distance(x, w, p=3),
    "norm_p_4": lambda x, w: D.norm_p_power_distance(x, w, p=4),
}


def main():
    enable_compile_cache()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", type=int, default=10000, help="number of samples")
    ap.add_argument("-w", type=int, default=256, help="number of codebook rows")
    ap.add_argument("-m", type=int, default=100, help="feature dimension")
    ap.add_argument("-r", type=int, default=10, help="repetitions")
    ap.add_argument("--only", nargs="*", default=None, help="subset of kernels")
    args = ap.parse_args()

    x = jnp.asarray(rand_samples(args.n, args.m, seed=0))
    w = jnp.asarray(rand_samples(args.w, args.m, seed=1))

    print(f"backend={jax.default_backend()} n={args.n} w={args.w} m={args.m}")
    names = args.only or list(CASES.keys())
    unknown = [n for n in names if n not in CASES]
    if unknown:
        raise SystemExit(
            f"unknown kernel(s) {unknown}; available: {', '.join(CASES)}"
        )
    for name in names:
        fn = jax.jit(CASES[name])
        print(bench(fn, x, w, name=name, reps=args.r))


if __name__ == "__main__":
    main()
