"""chip_smoke.py off the GPU, and the compile-cache placement the scripts
share (utils/compile_cache.py)."""

import json
import os
import shutil
import subprocess
import sys

import jax

from xpysom_dask_tpu.utils.compile_cache import CACHE_ENV, enable_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd, script, env_extra=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop(CACHE_ENV, None)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, script], capture_output=True, text=True, env=env,
        cwd=cwd, timeout=300,
    )


def test_chip_smoke_fails_on_cpu(tmp_path):
    """No GPU: non-zero exit, and the last line says ok: false."""
    cache = tmp_path / "cache"
    out = _run_smoke(REPO, "chip_smoke.py", {CACHE_ENV: str(cache)})
    assert out.returncode != 0
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is False and last["phase"] == "device"
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache
    and the helper sets no other."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(CACHE_ENV, str(tmp_path / "env_cache"))
    assert enable_compile_cache(str(tmp_path)) == str(tmp_path / "env_cache")
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_in_checkout(monkeypatch, tmp_path):
    """Unset: a fixed directory inside the checkout, listed in
    .gitignore — never a temporary or run-derived path."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(CACHE_ENV, raising=False)
    try:
        path = enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert enable_compile_cache(str(tmp_path)) == str(tmp_path / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
