#!/usr/bin/env python
"""Large-scale streamed + sharded training (the seismic-scale DASF
workload of BASELINE.json: huge-N data that doesn't fit on device).

Demonstrates the replacements for the reference's Dask layer:
- FileSource: native C++ double-buffered reader over a binary dataset
- mesh='auto': data-parallel shard_map over every local device
- per-epoch portable checkpoints

Defaults are sized to finish in seconds; crank N for a real run
(the north star is N=10^8, D=64, 128x128 codebook).
"""

import argparse
import os
import time

import numpy as np
import jax

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from xpysom_dask_tpu import XPySom
from xpysom_dask_tpu.parallel.pipeline import FileSource
from xpysom_dask_tpu.utils.native import native_available


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", type=int, default=1_000_000)
    ap.add_argument("-d", type=int, default=16)
    ap.add_argument("-x", type=int, default=32)
    ap.add_argument("-y", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--mesh", default=None, help="'auto', an int, or omit")
    ap.add_argument("--file", default="/tmp/xsom_demo.f32")
    args = ap.parse_args()

    if not os.path.exists(args.file) or os.path.getsize(args.file) != args.n * args.d * 4:
        print(f"generating {args.n * args.d * 4 / 1e6:.0f} MB dataset at {args.file}")
        rng = np.random.RandomState(0)
        with open(args.file, "wb") as f:
            block = 1 << 20
            for start in range(0, args.n, block):
                rows = min(block, args.n - start)
                f.write(rng.rand(rows, args.d).astype(np.float32).tobytes())

    mesh = args.mesh
    if isinstance(mesh, str) and mesh.isdigit():
        mesh = int(mesh)
    print(f"backend={jax.default_backend()} devices={len(jax.devices())} "
          f"native_loader={native_available()} mesh={mesh}")

    som = XPySom(args.x, args.y, args.d, random_seed=1, mesh=mesh)
    src = FileSource(args.file, args.n, args.d)
    t0 = time.time()
    som.train(src, args.epochs)
    dt = time.time() - t0
    print(f"{args.epochs} epochs x {args.n:,} rows in {dt:.1f}s "
          f"-> {args.epochs * args.n / dt:,.0f} samples/s")

    som.save_checkpoint("/tmp/xsom_demo_ckpt.npz", epoch=args.epochs)
    print("checkpoint written to /tmp/xsom_demo_ckpt.npz")


if __name__ == "__main__":
    main()
