"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

``reference(module)`` imports a module of the JAX package ``repro`` on
demand. Tests call it from fixtures, never while their module is imported,
so collecting the port's tests imports no part of ``repro``. The JAX
package imports ``jax.experimental.enable_x64``, a name that newer jax
releases dropped; importing this module installs it as an alias of
``jax.enable_x64`` when it is missing. It does so at import, not at the
first ``reference`` call, so that in every pytest worker the alias is in
place before any test runs, whichever files the worker is handed: a
reference test that imports ``repro.core`` inside its body
(``tests/test_kernels.py::test_robust_aggregate_kernel_matches_host_oracle``)
otherwise passes or fails with the order in which ``pytest-xdist`` deals
out the files. The alias also reaches the JAX package's own test files
that pytest collects after the first ``test_torch_*`` file: in a run of
the whole suite ``tests/test_wireless.py`` (11 tests) collects and passes,
where alone, under a jax without the name, it fails at collection. The
files collected before the first ``test_torch_*`` file are collected as
they are alone: the 15 that import ``repro.core`` when they are imported
still fail there. Importing it also points jax's persistent compilation
cache at a directory that the workers of one pytest-xdist run share
(``_share_compiled_programs``).

``ref_init_task(name)`` gives the port's ``run_experiment`` the
reference's initial params for task ``name`` (``mnist_mlp`` or
``lm_tiny``), computed by the reference from the port's key: the oracle
that ``tests/test_torch_init_parity.py`` holds the port's own init
against. ``run_recorded`` runs either package's
``run_experiment`` and hands back the server it ran, whose logs and host
RNG the result dict leaves out.

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


def _install_enable_x64_alias():
    import jax
    import jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)


_install_enable_x64_alias()


def _share_compiled_programs():
    """Under pytest-xdist, point jax's persistent compilation cache at one
    directory for the run's workers (named by the run's id, in the
    temporary directory), unless a cache is set already: a reference
    program that two test files compile (the same model at the same
    shapes) is compiled once in the run. A cached executable is the one
    the compiler made, so no result changes."""
    import os
    import tempfile

    import jax
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run is None or jax.config.jax_compilation_cache_dir:
        return
    jax.config.update("jax_compilation_cache_dir", os.path.join(
        tempfile.gettempdir(), f"repro-jax-cache-{run}"))


_share_compiled_programs()


def reference(module: str):
    """``repro.<module>``, imported with the ``enable_x64`` alias in place."""
    _install_enable_x64_alias()
    return importlib.import_module(f"repro.{module}")


def ref_init_task(name: str = "mnist_mlp"):
    """The port's task ``name`` with ``init_params(key, device)``
    replaced by the reference's: its ``task.init_params`` for the same
    key (``jax.random.PRNGKey(seed)``, with the seed the server drew from
    the host RNG), flattened (``convert.flatten_tree``) and converted to
    torch. The port's run then starts where the reference's does."""
    import jax
    import numpy as np

    from repro_torch.convert import flatten_tree, params_from_numpy
    from repro_torch.federated.task import as_task
    ref_task = reference("federated.task").as_task(name)

    class RefInitTask(type(as_task(name))):
        def init_params(self, key, device):
            p = ref_task.init_params(
                jax.numpy.asarray(key.cpu().numpy(), jax.numpy.uint32))
            return params_from_numpy(
                flatten_tree(jax.tree.map(np.asarray, p)), device)

    return RefInitTask()


def run_recorded(sim, **kw):
    """``sim.run_experiment(**kw)`` of either package -> (its result dict,
    the ``FeelServer`` it ran), so a test can read what the dict leaves out
    (per-round selections, the host RNG's next draw)."""
    servers = []

    class Recording(sim.FeelServer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            servers.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sim, "FeelServer", Recording)
        out = sim.run_experiment(**kw)
    return out, servers[0]


def nan64(sign: int = 1, payload: int = 0) -> float:
    """A float64 NaN of the given sign whose quiet NaN bits are OR-ed with
    ``payload``: the control plane's tests place NaNs of both signs and
    payloads, which numpy sorts alike and a sort by bits would not."""
    import numpy as np
    bits = np.array([np.nan]).view(np.uint64) | np.uint64(payload)
    if sign < 0:
        bits |= np.uint64(1 << 63)
    else:
        bits &= ~np.uint64(1 << 63)
    return float(bits.view(np.float64)[0])


@pytest.fixture(scope="module", autouse=True)
def single_threaded():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)
