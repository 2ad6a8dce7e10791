"""Direct tests for the n_parallel auto-sizing logic (utils/hw.py) — the
counterpart of the reference's CUDA-occupancy sizing (xpysom.py:242-251,
utils.py:4-20)."""

import numpy as np

from xpysom_dask_tpu.utils import hw


def test_round_up():
    assert hw.round_up(1, 256) == 256
    assert hw.round_up(256, 256) == 256
    assert hw.round_up(257, 256) == 512


def test_default_n_parallel_budget_honored():
    # Non-fused path: (chunk, XY) element budget respected after rounding
    for xy in (36, 900, 16384, 1 << 20):
        chunk = hw.default_n_parallel(xy, backend="gpu", fused=False)
        assert chunk % 256 == 0
        assert 256 <= chunk <= 65536
        if 256 < chunk < 65536:  # interior: within one rounding step of budget
            assert (chunk - 256) * xy <= (1 << 24)


def test_default_n_parallel_fused_tpu_fixed():
    # The fused kernel never materializes the matrix: a fixed chunk on the
    # GPU, whatever the map size; off the GPU there is no kernel
    assert hw.default_n_parallel(16384, backend="gpu", fused=True) == 16384
    assert hw.default_n_parallel(36, backend="gpu", fused=True) == 16384
    assert hw.default_n_parallel(16384, backend="cpu", fused=True) == 256


def test_default_n_parallel_cpu_smaller_budget():
    cpu = hw.default_n_parallel(4096, backend="cpu")
    gpu = hw.default_n_parallel(4096, backend="gpu")
    assert cpu <= gpu
    assert cpu == 256  # 2^20 budget / 4096 = 256


def test_find_cpu_cores_positive():
    assert hw.find_cpu_cores() >= 1


def test_constructor_uses_auto_sizing():
    from xpysom_dask_tpu import XPySom

    som = XPySom(6, 6, 4, random_seed=1)  # n_parallel=0 -> auto
    assert som._n_parallel >= 256
    som2 = XPySom(6, 6, 4, n_parallel=512, random_seed=1)
    assert som2._n_parallel == 512
    data = np.random.RandomState(0).rand(300, 4).astype(np.float32)
    som.train(data, 2)  # auto-sized chunk must actually train
