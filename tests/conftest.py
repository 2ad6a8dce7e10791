"""Test configuration: force an 8-virtual-device CPU platform so the
suite runs anywhere and the shard_map/psum data-parallel path is exercised
without several accelerators (SURVEY.md §4 implication (c)).

``JAX_PLATFORMS`` is set before JAX is imported and the config is updated
after, so an environment that points JAX at an accelerator cannot leak
in; XLA_FLAGS must carry the host-device-count flag before backend init.
The on-card checks live in ``tests_gpu/``.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
