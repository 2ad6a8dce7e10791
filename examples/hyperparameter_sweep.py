"""Hyperparameter sweep with SomPopulation: P maps behind one API.

The classic SOM model-selection loop — train several maps with different
seeds and σ schedules, keep the lowest-QE one — runs serially in the
reference (one full train per candidate). ``SomPopulation`` runs the
whole sweep through one call: with the default ``strategy='auto'``,
resident data routes to ``'serial'`` (each member rides the single-model
executables over one shared device-resident copy of the data; members
with identical schedules reuse ONE compiled program).
``strategy='batched'`` (the concatenated-codebook GEMM) and ``'fused'``
(per-member searches inside ``lax.map``, the streaming default) are
available explicitly — see docs/API.md for the routing.

Headless: prints the per-member QE table and the winning configuration.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from xpysom_dask_tpu import SomPopulation

# three well-separated gaussian blobs (the clustering example's data shape)
rng = np.random.RandomState(0)
centers = rng.rand(3, 16) * 4
data = np.concatenate(
    [c + 0.15 * rng.randn(400, 16) for c in centers]
).astype(np.float32)

# sweep: 4 sigmas x 2 seeds = 8 members, every other knob shared
sigmas = [0.8, 1.5, 2.5, 4.0] * 2
seeds = [10] * 4 + [20] * 4

pop = SomPopulation(
    8,
    12,
    12,
    16,
    sigma=sigmas,
    random_seed=seeds,
    learning_rate=0.5,
)
pop.train(data, 8)

qes = pop.quantization_errors(data)
print("member  sigma  seed   QE")
for i, (s, sd, q) in enumerate(zip(sigmas, seeds, qes)):
    print(f"{i:6d}  {s:5.1f}  {sd:4d}   {q:.4f}")

best = pop.best(data)
i_best = int(np.argmin(qes))
print(
    f"\nbest: member {i_best} (sigma={sigmas[i_best]}, seed={seeds[i_best]}) "
    f"QE={qes[i_best]:.4f}"
)
# the winner is a normal XPySom: full inference/analysis API
print("distance_map shape:", best.distance_map().shape)
# best(data) must agree with the QE table it is defined by
assert best is pop.member(i_best)
