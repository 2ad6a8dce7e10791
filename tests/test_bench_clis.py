"""Benchmark CLIs stay runnable (the reference's shipped broken with
stale imports — SURVEY §7; these smoke-run each one headless on CPU at
tiny shapes)."""

import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CLIS = [
    ("bench_distances.py", ["-n", "512", "-w", "64", "-m", "8", "-r", "2"]),
    ("bench_neighborhoods.py", ["-x", "8", "-y", "8", "-n", "64", "-r", "2"]),
    (
        "bench_som.py",
        ["-x", "8", "-y", "8", "-d", "4", "-n", "1024", "--chunk", "512",
         "-r", "2", "--epochs-per-rep", "2"],
    ),
]


@pytest.mark.parametrize("script,args", _CLIS, ids=[c[0] for c in _CLIS])
def test_bench_cli_runs(script, args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.join("benchmarks", script)] + args,
        env=env,
        cwd=_REPO,  # the CLIs sys.path.insert(0, ".")
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, f"{script}:\n{proc.stderr[-1500:]}"
    assert "mean=" in proc.stdout or "throughput" in proc.stdout
