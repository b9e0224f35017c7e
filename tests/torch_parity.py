"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

``reference(module)`` imports a module of the JAX package ``repro`` on
demand. Tests call it from fixtures, never while their module is imported,
so collecting the port's tests imports no part of ``repro``. The JAX
package imports ``jax.experimental.enable_x64``, a name that newer jax
releases dropped; ``reference`` installs it as an alias of
``jax.enable_x64`` first when it is missing.

``single_threaded`` pins torch to one CPU thread for a test module:
multi-threaded CPU matmuls split their reductions by thread count and by
batch size, so without it two computations of the same per-client product
can differ in the last bits, and the bit-exact checks inside the port would
depend on the machine.
"""
from __future__ import annotations

import importlib

import pytest
import torch


def reference(module: str):
    """``repro.<module>``, imported with the ``enable_x64`` alias in place."""
    import jax
    import jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
    return importlib.import_module(f"repro.{module}")


@pytest.fixture(scope="module", autouse=True)
def single_threaded():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)
