"""Streaming-pipeline and checkpoint tests: out-of-core training must be
numerically identical to resident training (the epoch is a pure reduction
over samples), and checkpoints must round-trip + resume exactly."""

import numpy as np
import pytest
import jax

from xpysom_dask_tpu import XPySom
from xpysom_dask_tpu.parallel.pipeline import ArraySource, train_streaming


def test_streaming_matches_resident():
    rng = np.random.RandomState(0)
    data = rng.rand(700, 5).astype(np.float32)
    resident = XPySom(6, 6, 5, random_seed=3, n_parallel=64)
    resident.train(data, 4)

    streamed = XPySom(6, 6, 5, random_seed=3, n_parallel=64)
    streamed.train(ArraySource(data), 4)
    # superbatch boundaries only change fp accumulation order
    np.testing.assert_allclose(
        streamed._weights, resident._weights, rtol=1e-4, atol=1e-5
    )


@pytest.mark.parametrize("split", ["0", "1"])
@pytest.mark.parametrize("superbatch_rows", [128, 320])
def test_streaming_equals_resident_across_superbatches(
    monkeypatch, split, superbatch_rows
):
    """Several superbatches per epoch: the stream continues the scan's
    accumulator from one superbatch to the next, so its additions happen
    in the resident epoch's order and the weights agree to the bit
    (folding per-superbatch totals instead drifts by near-tie flips)."""
    from xpysom_dask_tpu.core import clear_program_caches

    monkeypatch.setenv("XPYSOM_SPLIT_SCATTER", split)
    clear_program_caches()
    rng = np.random.RandomState(4)
    centres = rng.rand(8, 6).astype(np.float32)
    data = centres[rng.randint(0, 8, 1000)] + 0.05 * rng.randn(1000, 6).astype(
        np.float32
    )
    resident = XPySom(7, 7, 6, random_seed=5, n_parallel=64)
    resident.train(data, 4)
    w = train_streaming(
        resident._spec, XPySom(7, 7, 6, random_seed=5)._weights,
        ArraySource(data), 4, chunk=64, superbatch_rows=superbatch_rows,
    )
    clear_program_caches()
    np.testing.assert_array_equal(w, resident._weights)


def test_streaming_memmap(tmp_path):
    rng = np.random.RandomState(1)
    data = rng.rand(300, 4).astype(np.float32)
    f = tmp_path / "data.f32"
    data.tofile(f)
    mm = np.memmap(f, dtype=np.float32, mode="r", shape=(300, 4))

    resident = XPySom(5, 5, 4, random_seed=2, n_parallel=64)
    resident.train(data, 3)
    streamed = XPySom(5, 5, 4, random_seed=2, n_parallel=64)
    streamed.train(mm, 3)
    np.testing.assert_allclose(
        streamed._weights, resident._weights, rtol=1e-4, atol=1e-5
    )


def test_streaming_small_superbatches():
    """Many tiny superbatches (uneven tail) must fold identically."""
    rng = np.random.RandomState(2)
    data = rng.rand(333, 3).astype(np.float32)
    som = XPySom(4, 4, 3, random_seed=1, n_parallel=32)
    w = train_streaming(
        som._spec,
        np.asarray(som._weights, np.float32),
        ArraySource(data),
        3,
        chunk=32,
        superbatch_rows=50,
    )
    resident = XPySom(4, 4, 3, random_seed=1, n_parallel=32)
    resident.train(data, 3)
    np.testing.assert_allclose(w, resident._weights, rtol=1e-4, atol=1e-5)


def test_streaming_sharded():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    rng = np.random.RandomState(3)
    data = rng.rand(512, 4).astype(np.float32)
    single = XPySom(5, 5, 4, random_seed=5, n_parallel=32)
    single.train(data, 3)
    sharded = XPySom(5, 5, 4, random_seed=5, n_parallel=32, mesh=4)
    sharded.train(ArraySource(data), 3)
    np.testing.assert_allclose(
        sharded._weights, single._weights, rtol=1e-4, atol=1e-5
    )


def test_checkpoint_roundtrip_and_resume(tmp_path):
    rng = np.random.RandomState(4)
    data = rng.rand(256, 3).astype(np.float32)

    full = XPySom(5, 4, 3, sigma=1.5, random_seed=7)
    full.train(data, 6)

    half = XPySom(5, 4, 3, sigma=1.5, random_seed=7)
    half.train(data, 6, iter_beg=0, iter_end=3)
    ckpt = tmp_path / "som.npz"
    half.save_checkpoint(ckpt, epoch=3)

    resumed = XPySom.load_checkpoint(ckpt)
    assert resumed._checkpoint_epoch == 3
    np.testing.assert_array_equal(resumed._weights, half._weights)
    resumed.train(data, 6, iter_beg=3, iter_end=6)
    np.testing.assert_allclose(resumed._weights, full._weights, rtol=1e-5, atol=1e-6)


def test_checkpoint_without_epoch_resumes_from_zero(tmp_path):
    """save_checkpoint(path) with no epoch= must load with
    _checkpoint_epoch == 0 so the documented resume recipe
    train(..., iter_beg=ckpt._checkpoint_epoch) works (ADVICE r1)."""
    som = XPySom(4, 4, 2, random_seed=11)
    ckpt = tmp_path / "noepoch.npz"
    som.save_checkpoint(ckpt)
    loaded = XPySom.load_checkpoint(ckpt)
    assert loaded._checkpoint_epoch == 0
    data = np.random.RandomState(1).rand(32, 2).astype(np.float32)
    loaded.train(data, 2, iter_beg=loaded._checkpoint_epoch)  # must not raise


def test_streaming_verbose_prints_qe(capsys):
    """The streaming path must emit the same end-of-training QE line as
    the resident path / reference xpysom.py:591-592 (ADVICE r1)."""
    data = np.random.RandomState(5).rand(200, 3).astype(np.float32)
    som = XPySom(4, 4, 3, random_seed=1, n_parallel=32)
    som.train(ArraySource(data), 2, verbose=True)
    assert "quantization error" in capsys.readouterr().out


def test_checkpoint_preserves_rng_stream(tmp_path):
    som = XPySom(4, 4, 2, random_seed=9)
    data = np.random.RandomState(0).rand(20, 2)
    ckpt = tmp_path / "som.npz"
    som.save_checkpoint(ckpt)
    loaded = XPySom.load_checkpoint(ckpt)
    # the RNG stream continues identically after reload
    som.random_weights_init(data)
    loaded.random_weights_init(data)
    np.testing.assert_array_equal(som._weights, loaded._weights)


def test_checkpoint_config_roundtrip(tmp_path):
    som = XPySom(
        3,
        7,
        2,
        topology="hexagonal",
        neighborhood_function="mexican_hat",
        activation_distance="norm_p",
        activation_distance_kwargs={"p": 4},
        compact_support=True,
        std_coeff=1.2,
        decay_function="linear",
        random_seed=1,
    )
    ckpt = tmp_path / "som.npz"
    som.save_checkpoint(ckpt)
    loaded = XPySom.load_checkpoint(ckpt)
    assert loaded.topology == "hexagonal"
    assert loaded.neighborhood_func_name == "mexican_hat"
    assert loaded._activation_distance_name == "norm_p"
    assert loaded._activation_distance_kwargs == {"p": 4}
    assert loaded.compact_support is True
    assert loaded._std_coeff == 1.2
    assert loaded._decay_function_name == "linear"


def test_periodic_checkpointing(tmp_path):
    """checkpoint_every writes resumable checkpoints and ends at the same
    weights as an uninterrupted run."""
    rng = np.random.RandomState(6)
    data = rng.rand(128, 3).astype(np.float32)
    ckpt = tmp_path / "periodic.npz"

    full = XPySom(4, 4, 3, random_seed=11)
    full.train(data, 6)

    ck = XPySom(4, 4, 3, random_seed=11)
    ck.train(data, 6, checkpoint_path=ckpt, checkpoint_every=2)
    np.testing.assert_allclose(ck._weights, full._weights, rtol=1e-5, atol=1e-6)

    # simulate failure recovery from the last checkpoint
    loaded = XPySom.load_checkpoint(ckpt)
    assert loaded._checkpoint_epoch == 6
    np.testing.assert_array_equal(loaded._weights, ck._weights)


def test_iterable_source_matches_resident():
    """IterableSource (generator factory, odd batch sizes) == resident."""
    from xpysom_dask_tpu.parallel.pipeline import IterableSource

    rng = np.random.RandomState(8)
    data = rng.rand(450, 4).astype(np.float32)

    def factory():
        for start in range(0, 450, 77):  # ragged producer batches
            yield data[start : start + 77]

    resident = XPySom(5, 5, 4, random_seed=6, n_parallel=64)
    resident.train(data, 3)
    streamed = XPySom(5, 5, 4, random_seed=6, n_parallel=64)
    streamed.train(IterableSource(factory, 450, 4), 3)
    np.testing.assert_allclose(
        streamed._weights, resident._weights, rtol=1e-4, atol=1e-5
    )


def test_iterable_source_reblocks():
    from xpysom_dask_tpu.parallel.pipeline import IterableSource

    data = np.arange(100 * 2, dtype=np.float32).reshape(100, 2)

    def factory():
        yield data[:37]
        yield data[37:90]
        yield data[90:]

    src = IterableSource(factory, 100, 2)
    blocks = list(src.superbatches(40))
    assert [b.shape[0] for b in blocks] == [40, 40, 20]
    np.testing.assert_array_equal(np.concatenate(blocks), data)
    # re-iterable: second epoch sees the same rows
    np.testing.assert_array_equal(
        np.concatenate(list(src.superbatches(64))), data
    )


def test_epoch_timer_and_trace(tmp_path):
    from xpysom_dask_tpu.utils.profiling import EpochTimer, annotate, trace

    timer = EpochTimer()
    som = XPySom(4, 4, 2, random_seed=0)
    data = np.random.RandomState(0).rand(64, 2).astype(np.float32)
    with trace(tmp_path):
        with annotate("epochs"):
            for t in range(3):
                som.train(data, 3, iter_beg=t, iter_end=t + 1)
                timer.tick()
    assert len(timer.durations) == 3
    assert "3 epochs" in timer.summary()
    import os

    written = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert written, "profiler trace should write files"


def test_checkpoint_extensionless_path(tmp_path):
    """save->load must round-trip for paths without the .npz extension
    (np.savez appends it on write)."""
    som = XPySom(3, 3, 2, random_seed=1)
    p = tmp_path / "ck"  # no extension
    som.save_checkpoint(p, epoch=1)
    loaded = XPySom.load_checkpoint(p)
    np.testing.assert_array_equal(loaded._weights, som._weights)
    assert loaded._checkpoint_epoch == 1


def test_load_checkpoint_rejects_non_checkpoint_npz(tmp_path):
    import pytest

    from xpysom_dask_tpu.utils.serialization import load_checkpoint

    p = tmp_path / "not_a_ckpt.npz"
    np.savez(p, foo=np.zeros(3))
    with pytest.raises(ValueError, match="not an xpysom checkpoint"):
        load_checkpoint(p)


def test_load_checkpoint_rejects_shape_mismatch(tmp_path):
    import pytest

    from xpysom_dask_tpu import XPySom
    from xpysom_dask_tpu.utils.serialization import load_checkpoint

    som = XPySom(4, 3, 2, random_seed=1)
    p = tmp_path / "ckpt.npz"
    som.save_checkpoint(p, epoch=1)
    # corrupt: swap in wrongly-shaped weights, keep everything else
    with np.load(p) as z:
        entries = {k: z[k] for k in z.files}
    entries["weights"] = np.zeros((2, 2, 2), dtype=np.float32)
    np.savez(p, **entries)
    with pytest.raises(ValueError, match="does not match its own config"):
        load_checkpoint(p)


def test_streaming_inference_matches_resident():
    """predict/quantization_error/topographic_error accept sources and
    stream superbatches; results must equal the resident path."""
    from xpysom_dask_tpu import XPySom
    from xpysom_dask_tpu.parallel.pipeline import ArraySource

    rng = np.random.RandomState(3)
    data = rng.rand(5000, 6).astype(np.float32)
    som = XPySom(7, 6, 6, sigma=2.0, random_seed=2)
    som.train(data, 4)
    # force several superbatches so the cross-block accumulation is real
    som._superbatch_rows = lambda: 1500

    src = ArraySource(data)
    np.testing.assert_array_equal(som.predict(src), som.predict(data))
    assert som.quantization_error(src) == pytest.approx(
        som.quantization_error(data), rel=1e-6
    )
    assert som.topographic_error(src) == pytest.approx(
        som.topographic_error(data), rel=1e-6
    )


def test_streaming_inference_memmap(tmp_path):
    from xpysom_dask_tpu import XPySom

    rng = np.random.RandomState(4)
    data = rng.rand(3000, 5).astype(np.float32)
    p = tmp_path / "d.f32"
    data.tofile(p)
    mm = np.memmap(p, dtype=np.float32, mode="r", shape=(3000, 5))
    som = XPySom(6, 6, 5, sigma=2.0, random_seed=1)
    som.train(data, 3)
    np.testing.assert_array_equal(som.predict(mm), som.predict(data))
    assert som.quantization_error(mm) == pytest.approx(
        som.quantization_error(data), rel=1e-6
    )


def test_streaming_activation_response_matches_resident():
    from xpysom_dask_tpu import XPySom
    from xpysom_dask_tpu.parallel.pipeline import ArraySource

    rng = np.random.RandomState(7)
    data = rng.rand(4000, 5).astype(np.float32)
    som = XPySom(6, 5, 5, sigma=2.0, random_seed=3)
    som.train(data, 3)
    som._superbatch_rows = lambda: 1024  # force several blocks
    np.testing.assert_array_equal(
        som.activation_response(ArraySource(data)),
        som.activation_response(data),
    )
    assert som.activation_response(data).sum() == len(data)


def test_sharded_file_source_round_robin_and_parity(tmp_path):
    """ShardedFileSource: rows inferred from file sizes, round-robin
    shard assignment per process, streamed training == resident on the
    concatenated shards (single-process case)."""
    from xpysom_dask_tpu.parallel.pipeline import ShardedFileSource

    rng = np.random.RandomState(4)
    shard_sizes = [130, 70, 200]  # ragged: re-blocking must cross files
    shards = [rng.rand(n, 4).astype(np.float32) for n in shard_sizes]
    files = []
    for i, s in enumerate(shards):
        p = tmp_path / f"shard{i}.f32"
        s.tofile(p)
        files.append(p)

    src = ShardedFileSource(files, 4, process_id=0, num_processes=1)
    assert len(src) == sum(shard_sizes)
    assert src.dim == 4
    # superbatches re-block across shard boundaries
    blocks = list(src.superbatches(64))
    assert [b.shape[0] for b in blocks[:-1]] == [64] * (len(blocks) - 1)
    np.testing.assert_array_equal(np.concatenate(blocks), np.concatenate(shards))

    data = np.concatenate(shards)
    resident = XPySom(5, 5, 4, random_seed=3, n_parallel=64)
    resident.train(data, 3)
    streamed = XPySom(5, 5, 4, random_seed=3, n_parallel=64)
    streamed.train(
        ShardedFileSource(files, 4, process_id=0, num_processes=1), 3
    )
    np.testing.assert_allclose(
        streamed._weights, resident._weights, rtol=1e-4, atol=1e-5
    )


def test_sharded_file_source_process_slicing(tmp_path):
    """Two processes split the shard list round-robin and disjointly;
    a process with no shard streams nothing; size/validation errors."""
    from xpysom_dask_tpu.parallel.pipeline import ShardedFileSource

    rng = np.random.RandomState(5)
    shards = [rng.rand(n, 3).astype(np.float32) for n in (40, 50, 60)]
    files = []
    for i, s in enumerate(shards):
        p = tmp_path / f"s{i}.f32"
        s.tofile(p)
        files.append(p)

    a = ShardedFileSource(files, 3, process_id=0, num_processes=2)
    b = ShardedFileSource(files, 3, process_id=1, num_processes=2)
    assert [str(f) for f in a.files] == [str(files[0]), str(files[2])]
    assert [str(f) for f in b.files] == [str(files[1])]
    assert len(a) == 100 and len(b) == 50
    # a third process beyond the shard count gets an empty stream
    c = ShardedFileSource(files[:1], 3, process_id=1, num_processes=2)
    assert len(c) == 0 and list(c.superbatches(32)) == []

    with pytest.raises(ValueError, match="whole number"):
        ShardedFileSource(files, 4, process_id=0, num_processes=1)
    with pytest.raises(ValueError, match="at least one"):
        ShardedFileSource([], 3)
    with pytest.raises(ValueError, match="out of range"):
        ShardedFileSource(files, 3, process_id=2, num_processes=2)
