"""Time the fused BMU kernel's block candidates on the attached GPU.

Run from the repository root on a machine with a GPU:

    python benchmarks/bmu_blocks.py [--n 16384] [--xy 16384] [--d 64,512]

For each feature width in ``--d`` and each ``(BN, BJ, num_warps,
num_stages)`` candidate (the width's current table entry first) it
compiles the kernel at the given search shape, after the kernel's own
shared-memory fit (candidates that fit to the same blocks run once),
checks the winners against a float64 NumPy reference on the first rows,
and times the search (median of dispatches that each run the search
``--inner`` times; with ``--top2`` the top-2 search too), beside the XLA
reference path. The codebook is
centred as the library centres it (``core.codebook_center``). The winner
per feature width goes into ``ops.pallas.bmu._BLOCKS``; the widest width
where the kernel beats XLA bounds ``ops.pallas.bmu.MAX_D``. One JSON
line per candidate is printed and, with ``--out``, appended to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, ".")  # allow running from the repo root

from benchmarks.bench_utils import card, median_ms, repeated  # noqa: E402
from xpysom_dask_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

CANDIDATES = (
    (64, 128, 4, 3),
    (32, 128, 4, 3),
    (64, 64, 4, 3),
    (64, 128, 4, 2),
    (64, 128, 8, 3),
    (128, 64, 4, 3),
    (128, 128, 8, 3),
    (64, 256, 8, 3),
    (128, 128, 4, 2),
    (32, 64, 4, 2),
    (16, 64, 4, 2),
    (32, 32, 4, 3),
    (16, 32, 4, 2),
    (16, 128, 4, 1),
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--xy", type=int, default=16384)
    ap.add_argument("--d", default="64",
                    help="comma-separated feature widths")
    ap.add_argument("--inner", type=int, default=10)
    ap.add_argument("--mode", default="packed")
    ap.add_argument("--top2", action="store_true",
                    help="also time each candidate's top-2 search")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    enable_compile_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, found {dev.platform}")
    rows = []
    for d in (int(v) for v in args.d.split(",")):
        rows += _width(args, d, dev)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")


def _width(args, d, dev):
    import jax
    import jax.numpy as jnp

    from xpysom_dask_tpu.core import codebook_center
    from xpysom_dask_tpu.ops.distances import euclidean_squared_distance_part
    from xpysom_dask_tpu.ops.pallas import bmu as K

    head = {
        "platform": dev.platform, "kind": dev.device_kind,
        "card": card(), "n": args.n, "xy": args.xy, "d": d,
        "mode": args.mode,
    }
    print(json.dumps(head), flush=True)
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.rand(args.n, d).astype(np.float32))
    w = jnp.asarray(rng.rand(args.xy, d).astype(np.float32))
    xs, ws = np.asarray(x[:2048], np.float64), np.asarray(w, np.float64)
    ref = (-2 * xs @ ws.T + (ws**2).sum(1)).argmin(1)
    center = codebook_center(w)
    rows = []

    def record(name, search):
        row = dict(head, name=name)
        try:
            idx = np.asarray(jax.jit(lambda a: search(a)[0])(x[:2048]))
            row["flips_vs_f64"] = int((idx != ref).sum())
            row["ms"] = median_ms(repeated(search, args.inner), x) / args.inner
        except Exception as e:  # a candidate the compiler refuses
            row["error"] = f"{type(e).__name__}: {e}"[:300]
        print(json.dumps(row), flush=True)
        rows.append(row)

    record("xla", lambda a: (jnp.argmin(
        euclidean_squared_distance_part(a, w), axis=1),))
    d_pad = K._pow2_at_least(d)
    n_x, n_w = {"packed": (2, 2), "split2": (2, 1), "bf16": (1, 1)}[args.mode]
    seen = set()
    for blocks in (K.blocks_for(d),) + CANDIDATES:
        fitted = K._resolve_blocks(args.xy, d_pad, blocks, n_x, n_w)
        if fitted in seen:
            continue
        seen.add(fitted)
        for top2 in (False, True) if args.top2 else (False,):
            record(
                f"kernel{fitted}{'-top2' if top2 else ''}",
                K.searcher(w, center=center, mode=args.mode, blocks=fitted,
                           top2=top2),
            )
    return rows


if __name__ == "__main__":
    main()
