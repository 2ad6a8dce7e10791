#!/usr/bin/env python
"""Neighborhood-kernel benchmark CLI.

Mirror of the reference CLI (``benchmarks/bench_neighborhoods.py``: 64×64
grid default — bench_neighborhoods.py:48) with correct package imports.
Benchmarks both the batched per-center kernels and the factorized operator
form the training update actually uses.
"""

import argparse
import sys

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from xpysom_dask_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from benchmarks.bench_utils import bench  # noqa: E402
from xpysom_dask_tpu.core import grid_coordinates  # noqa: E402
from xpysom_dask_tpu.ops import neighborhoods as NB  # noqa: E402


def main():
    enable_compile_cache()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-x", type=int, default=64)
    ap.add_argument("-y", type=int, default=64)
    ap.add_argument("-n", type=int, default=4096, help="batch of centers")
    ap.add_argument("-r", type=int, default=10)
    ap.add_argument("--sigma", type=float, default=4.0)
    ap.add_argument("--topology", default="rectangular",
                    choices=["rectangular", "hexagonal"])
    args = ap.parse_args()

    x, y = args.x, args.y
    rng = np.random.RandomState(0)
    c = (
        jnp.asarray(rng.randint(0, x, size=args.n)),
        jnp.asarray(rng.randint(0, y, size=args.n)),
    )
    neigx = jnp.arange(x, dtype=jnp.float32)
    neigy = jnp.arange(y, dtype=jnp.float32)
    xxn, yyn = grid_coordinates(x, y, args.topology)
    xx = jnp.asarray(xxn, jnp.float32)
    yy = jnp.asarray(yyn, jnp.float32)

    print(f"backend={jax.default_backend()} grid={x}x{y} n={args.n} "
          f"sigma={args.sigma} topology={args.topology}")

    if args.topology == "rectangular":
        cases = {
            "gaussian_rect": lambda c, s: NB.gaussian_rect(neigx, neigy, 0.5, False, c, s),
            "mexican_hat_rect": lambda c, s: NB.mexican_hat_rect(neigx, neigy, 0.5, False, c, s),
            "bubble": lambda c, s: NB.bubble(neigx, neigy, c, s),
            "triangle": lambda c, s: NB.triangle(neigx, neigy, False, c, s),
        }
    else:
        cases = {
            "gaussian_generic": lambda c, s: NB.gaussian_generic(xx, yy, 0.5, False, c, s),
            "mexican_hat_generic": lambda c, s: NB.mexican_hat_generic(xx, yy, 0.5, False, c, s),
            "bubble": lambda c, s: NB.bubble(neigx, neigy, c, s),
        }
    for name, fn in cases.items():
        print(bench(jax.jit(fn), c, args.sigma, name=name, reps=args.r))

    # operator form (what the training update uses): build + apply
    s_stats = jnp.asarray(rng.rand(x * y, 16).astype(np.float32))
    cnt = jnp.asarray(rng.rand(x * y).astype(np.float32))
    for name in (
        ["gaussian", "mexican_hat", "bubble", "triangle"]
        if args.topology == "rectangular"
        else ["gaussian", "mexican_hat", "bubble"]
    ):
        def op_apply(s_stats, cnt, sigma, name=name):
            op = NB.neighborhood_operator(
                name, args.topology, neigx, neigy, xx, yy, 0.5, False, sigma
            )
            return NB.apply_operator(op, s_stats, cnt)

        print(
            bench(
                jax.jit(op_apply),
                s_stats,
                cnt,
                args.sigma,
                name=f"operator_{name}",
                reps=args.r,
            )
        )


if __name__ == "__main__":
    main()
