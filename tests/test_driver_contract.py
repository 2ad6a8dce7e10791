"""Guards for the entry points: bench.py must print its JSON lines;
__graft_entry__.entry must be jittable and dryrun_multichip must run on
a virtual CPU device mesh; chunk_data edge cases."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax

from xpysom_dask_tpu.core import chunk_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# search_inner=1 is the degenerate smoke shrink (one search per timed
# dispatch): metric 2 must still honor the 4-key contract
@pytest.mark.parametrize("search_inner", [None, "1"])
def test_bench_emits_one_json_line(search_inner):
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XSOM_BENCH_XY="8",
        XSOM_BENCH_D="4",
        XSOM_BENCH_N="2048",
        XSOM_BENCH_CHUNK="256",
        XSOM_BENCH_EPOCHS="2",
        XSOM_BENCH_SEARCH_N="512",
    )
    if search_inner is not None:
        env["XSOM_BENCH_SEARCH_INNER"] = search_inner
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        capture_output=True,
        text=True,
        env=env,
        cwd=REPO,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-500:]
    lines = [l for l in out.stdout.strip().splitlines() if l.startswith("{")]
    # bench.py emits both metrics — BMU argmin throughput first, the
    # headline training metric LAST (the last line is the headline)
    assert len(lines) == 2
    for line in lines:
        rec = json.loads(line)
        assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
        assert rec["value"] > 0
    assert json.loads(lines[0])["metric"] == "bmu_argmin_searches_per_sec"
    assert (
        json.loads(lines[-1])["metric"]
        == "som_batch_step_samples_per_sec_per_chip"
    )


def test_graft_entry(monkeypatch):
    monkeypatch.syspath_prepend(REPO)  # auto-restored, no session leak
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == args[0].shape
    if len(jax.devices()) >= 8:
        g.dryrun_multichip(8)


def test_dryrun_multichip_self_provisions_like_driver():
    """A fresh CPU process whose JAX platform has ONE device, already
    initialised (no conftest platform forcing, no host-device-count
    flag): ``dryrun_multichip(8)`` must provision a virtual 8-CPU mesh
    in-process and run every strategy."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # Strip the conftest-injected virtual-device flag: the driver's
    # process sees exactly one device, and so must this one.
    env["XLA_FLAGS"] = " ".join(
        f
        for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    out = subprocess.run(
        [
            sys.executable,
            "-c",
            "import jax; assert len(jax.devices()) == 1, jax.devices(); "
            "import __graft_entry__ as g; g.dryrun_multichip(8); "
            "print('DRYRUN_OK')",
        ],
        capture_output=True,
        text=True,
        env=env,
        cwd=REPO,
        timeout=600,
    )
    assert out.returncode == 0, (out.stdout + out.stderr)[-2000:]
    assert "DRYRUN_OK" in out.stdout
    # the whole point of the parity dryrun: the output carries the
    # strategy verdicts
    for line in (
        "dryrun parity [1-D data mesh x8]",
        "dryrun parity [2-D (data=4, model=2) mesh]",
        "dryrun parity [population P=3 over data mesh x8]",
    ):
        assert line in out.stdout, out.stdout[-2000:]


def test_dryrun_multichip_never_provisions_off_cpu(monkeypatch):
    """Only a CPU process provisions virtual devices: on an accelerator
    backend with too few devices the dryrun fails instead of silently
    moving to the CPU."""
    monkeypatch.syspath_prepend(REPO)
    import __graft_entry__ as g

    n = len(jax.devices()) + 1
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with pytest.raises(AssertionError, match=f"need {n} devices"):
        g.dryrun_multichip(n)
    assert len(jax.devices()) == n - 1


@pytest.mark.parametrize(
    "n,chunk,mult",
    [(1, 8, 1), (7, 8, 1), (8, 8, 1), (9, 8, 1), (5, 8, 4), (100, 32, 8)],
)
def test_chunk_data_edges(n, chunk, mult):
    data = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    chunks, mask, n_out = chunk_data(data, chunk, multiple_of=mult)
    assert n_out == n
    assert chunks.shape[0] % mult == 0
    assert chunks.shape[1] == chunk
    flat = chunks.reshape(-1, 3)
    m = mask.reshape(-1)
    assert m.sum() == n
    np.testing.assert_array_equal(flat[m.astype(bool)], data)
    assert np.all(flat[~m.astype(bool)] == 0)
