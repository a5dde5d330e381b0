"""The persistent-cache fixture of the port's parity tests.

Every tests/test_torch_*.py that holds the port to JAX imports
:func:`jax_reference_private_cache` (autouse, module scope), so that its JAX
references are compiled into a persistent cache of the process's own
(``private-<pid>`` inside the shared one) and never read from the cache that
the test workers share: its files are written in place, unlocked, by several
processes at once, and the same program's entry differs byte for byte
between processes. This module imports JAX and nothing else of the tests, so
that the rank processes of tests/test_torch_parallel.py need not load it.
"""

import os

import pytest


@pytest.fixture(scope="module", autouse=True)
def jax_reference_private_cache():
    """Point JAX's persistent cache at ``<shared>/private-<pid>`` for the
    module and drop the executables this process took from the shared
    cache earlier; put the shared cache back after the module."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache

    shared = jax.config.jax_compilation_cache_dir
    if shared:
        jax.config.update("jax_compilation_cache_dir", os.path.join(shared, f"private-{os.getpid()}"))
        compilation_cache.reset_cache()
    jax.clear_caches()
    yield
    if shared:
        jax.config.update("jax_compilation_cache_dir", shared)
        compilation_cache.reset_cache()


def test_cache_is_this_process_own():
    """Inside a module that uses the fixture, the cache directory is this
    process's own, below the shared one that tests/conftest.py set."""
    import jax

    here = jax.config.jax_compilation_cache_dir
    assert here and os.path.basename(here) == f"private-{os.getpid()}"
    assert os.path.dirname(here).endswith(".jax_cache")


def test_programs_compile_into_the_private_cache():
    """A program compiled here lands in the private directory: the shared
    one gets no entry from this module."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    here = jax.config.jax_compilation_cache_dir
    before = set(os.listdir(here)) if os.path.isdir(here) else set()
    # a program no other test compiles: the constant is this process's id
    f = jax.jit(lambda x: jnp.tanh(x) * float(os.getpid() % 9973 + 0.5))
    np.testing.assert_allclose(np.asarray(f(jnp.ones(3))), np.tanh(1.0) * (os.getpid() % 9973 + 0.5), rtol=1e-6)
    assert set(os.listdir(here)) - before
