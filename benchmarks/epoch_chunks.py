"""Time one training epoch per chunk size, and check that it repeats.

Run from the repository root on a machine with a GPU:

    python benchmarks/epoch_chunks.py [--n 4194304] [--kernel-chunks 8192,16384]

One epoch of the flagship map (128×128×64, clustered samples) through
``core.make_train_fn``, for the fused BMU kernel at each of
``--kernel-chunks`` rows per chunk and for the XLA reference at each of
``--xla-chunks``. Each arm is compiled first, then timed in turns
(forward, then backward over the arms). Then the epoch is repeated from
the same codebook on the same device arrays, once and for ``--epochs``
epochs, and the largest weight difference between the two runs is
printed: zero when the epoch program is deterministic on this device.
``--f32-scatter`` adds kernel arms whose statistics are a plain f32
scatter-add instead of ``core.scatter_sum`` (which makes the sums
independent of the order of the additions), to see what that costs.
One JSON line per reading; ``--out`` also appends them to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")  # allow running from the repo root

from benchmarks.bench_utils import card, clustered  # noqa: E402
from xpysom_dask_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def _ints(s):
    return [int(v) for v in s.split(",") if v]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 22)
    ap.add_argument("--side", type=int, default=128)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--kernel-chunks", type=_ints, default=[8192, 16384, 32768, 65536])
    ap.add_argument("--xla-chunks", type=_ints, default=[1024, 16384])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--f32-scatter", action="store_true",
                    help="also time kernel arms with a plain f32 scatter-add")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from xpysom_dask_tpu import core

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, found {dev.platform}")
    side, d = args.side, args.d
    head = {
        "kind": dev.device_kind, "card": card(), "n": args.n,
        "map": [side, side, d], "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }
    rows = []

    def emit(**kw):
        row = dict(head, **kw)
        print(json.dumps(row), flush=True)
        rows.append(row)

    data = clustered(args.n, d, args.seed)
    w0 = jnp.asarray(np.random.default_rng(args.seed + 1).random(
        (side, side, d), dtype=np.float32))

    def f32_scatter(idx, upd, n_out):
        return jnp.zeros((n_out, upd.shape[1]), jnp.float32).at[idx].add(upd)

    variants = [("kernel", True, args.kernel_chunks, core.scatter_sum),
                ("xla", False, args.xla_chunks, core.scatter_sum)]
    if args.f32_scatter:
        variants.append(("kernel-f32scatter", True, args.kernel_chunks, f32_scatter))
    arms = {}
    for path, use_pallas, chunks, scatter in variants:
        core.scatter_sum = scatter  # read when the epoch program is traced
        core.clear_program_caches()
        spec = core.SomSpec(side, side, d, side / 2, 1.0, 0.5, 0.01,
                            use_pallas=use_pallas)
        fn = core.make_train_fn(spec, 10)
        for chunk in chunks:
            c, m, _ = core.chunk_data(data, chunk)
            c, m = jnp.asarray(c), jnp.asarray(m)
            jax.block_until_ready(fn(jnp.copy(w0), c, m, 0, 1))  # compile
            arms[(path, chunk)] = (fn, c, m)
    del data

    def run(arm, t0, t1):
        fn, c, m = arms[arm]
        w = jax.block_until_ready(jnp.copy(w0))  # the codebook is donated
        start = time.perf_counter()
        w = jax.block_until_ready(fn(w, c, m, t0, t1))
        return (time.perf_counter() - start) * 1e3, w

    order = list(arms)
    times = {arm: [] for arm in order}
    for arm in order + order[::-1]:
        times[arm].append(run(arm, 0, 1)[0])
    for (path, chunk), ms in times.items():
        emit(reading="epoch_ms", path=path, chunk=chunk, ms=ms)

    for arm in order:
        for epochs in (1, args.epochs):
            a = np.asarray(run(arm, 0, epochs)[1])
            b = np.asarray(run(arm, 0, epochs)[1])
            emit(reading="repeat", path=arm[0], chunk=arm[1], epochs=epochs,
                 max_abs_dw=float(np.abs(a - b).max()),
                 identical=bool(np.array_equal(a, b)))

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
