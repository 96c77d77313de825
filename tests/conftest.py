"""Test configuration: run everything on a virtual 8-device CPU mesh.

Sets XLA_FLAGS before jax import (must precede backend init), then forces
the cpu platform via jax.config, so the tests never take the GPU.
Multi-device sharding logic is validated on these virtual devices.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)


# XLA's in-process compiler has crashed (SIGSEGV once, SIGABRT once, both
# inside backend_compile_and_load) late in full-suite runs, after ~2500+
# cumulative compilations across the process — different victim tests each
# time, so it is global executable accumulation, not one test's usage.
# Bound the buildup: drop all live executables every N tests. Cross-test
# cache reuse is minimal anyway (tests build their own closures), so the
# cost is a few re-traced shared helpers.
_CLEAR_EVERY = 40
_test_counter = [0]

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _bound_xla_executable_buildup():
    yield
    _test_counter[0] += 1
    if _test_counter[0] % _CLEAR_EVERY == 0:
        jax.clear_caches()
