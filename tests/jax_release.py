"""A module fixture for the port's test files: free the JAX programs a
module compiled when it ends.

Every compiled XLA program keeps its machine code in memory mappings of
its own, and JAX caches the programs for the life of the process. One
test worker runs many modules, so without a release its mappings grow
past the kernel's per-process limit (`vm.max_map_count`, 65,530 by
default); the next compilation then fails inside XLA and the worker dies
with a segmentation fault. Import the fixture into a test module to use it:

    from jax_release import release_jax_programs  # noqa: F401
"""
import gc

import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def release_jax_programs():
    yield
    jax.clear_caches()
    gc.collect()
