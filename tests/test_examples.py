"""Smoke-run the full example catalog (SURVEY.md §2.9 workloads) headless
on the CPU platform — every reference notebook counterpart must stay
runnable end-to-end, not just exist."""

import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXAMPLES = os.path.join(_REPO, "examples")

_ALL = sorted(
    f[:-3]
    for f in os.listdir(_EXAMPLES)
    if f.endswith(".py") and f != "__init__.py"
)

# shrink the only long-running workload to smoke size
_EXTRA_ARGS = {"large_scale_streaming": ["-n", "100000", "--epochs", "2"]}


def test_catalog_complete():
    """The 14 reference workloads (SURVEY §2.9, some sharing a script)
    plus the streaming demo must all be present."""
    assert len(_ALL) >= 15, _ALL


@pytest.mark.parametrize("name", _ALL)
def test_example_runs(name):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XPYSOM_BMU_PRECISION", None)
    env["MPLBACKEND"] = "Agg"
    proc = subprocess.run(
        [sys.executable, os.path.join(_EXAMPLES, f"{name}.py")]
        + _EXTRA_ARGS.get(name, []),
        env=env,
        cwd=_REPO,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, (
        f"{name}.py failed:\n{proc.stderr[-1500:]}"
    )
