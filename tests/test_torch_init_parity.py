"""The port's model init against the reference's, with no params carried
across: the same ``PRNGKey`` gives the same tree (``repro_torch.random``,
the reference's split tree in each initializer).

Leaf for leaf, bit for bit, names, shapes and dtypes included:
``mlp_init``, ``lm_init`` for ``lm_tiny``, each task's ``init_params`` and
``api.init`` for the zoo's ten archs reduced as the zoo tests reduce them
(``registry.reduced``, in their bfloat16 and in float32).

End to end, the port's ``run_experiment`` from its **own** init (no
``ref_init_task``) beside the reference's: the §V MLP (K = 50, 3,000/500,
2 rounds), a defended run (tests/test_torch_simulation_defenses.py's
config, trimmed mean under sign flip) and ``lm_tiny``
(tests/test_torch_lm_task.py's run). Exact: selections, the exact fields
and the host RNG's next draw; within the injected tests' tolerances:
accuracies 1e-2, the LM loss 1e-3. The port's own-init run is also bit
for bit its run from the injected reference params (the same initial
params). ``examples/federated_llm_torch.py``'s leg 1 from the port's
own init (seed 0, 2 rounds) is held against the reference driver's leg 1
in tests/test_torch_examples_federated_llm.py, which runs that reference
leg once for it and for the twin started from the reference's params.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import (ref_init_task, reference, run_recorded,  # noqa: F401
                          single_threaded)

from repro_torch.configs import registry
from repro_torch.configs.base import FeelConfig
from repro_torch.convert import flatten_tree
from repro_torch.federated import simulation
from repro_torch.federated.task import LM_TINY
from repro_torch.models import api
from repro_torch.models.mlp import mlp_init
from repro_torch.models.transformer import lm_init
from repro_torch.random import PRNGKey

ARCHS = ["chameleon-34b", "deepseek-v3-671b", "jamba-1.5-large-398b",
         "mamba2-370m", "moonshot-v1-16b-a3b", "qwen2-moe-a2.7b",
         "qwen2.5-32b", "seamless-m4t-medium", "starcoder2-15b", "yi-34b"]


@pytest.fixture(scope="module")
def ref():
    import types

    import jax
    return types.SimpleNamespace(
        jax=jax, mlp=reference("models.mlp"), tr=reference("models.transformer"),
        task=reference("federated.task"), api=reference("models.api"),
        reg=reference("configs.registry"))


def _tree(ref, p):
    return flatten_tree(ref.jax.tree.map(np.asarray, p))


def assert_same_tree(got, want):
    """Names, shapes, dtypes and every bit of every leaf."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (k, g.dtype)
        bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
        if g.dtype in bits:
            g = g.view(bits[g.dtype])
            w = np.asarray(w).view(str(g.dtype).split(".")[-1])
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mlp_init_is_the_references(ref, seed):
    got = mlp_init(PRNGKey(seed, "cpu"), device="cpu")
    want = _tree(ref, ref.mlp.mlp_init(ref.jax.random.PRNGKey(seed)))
    assert_same_tree(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_lm_tiny_init_is_the_references(ref, seed):
    got = lm_init(PRNGKey(seed, "cpu"), LM_TINY)
    want = _tree(ref, ref.tr.lm_init(ref.jax.random.PRNGKey(seed),
                                     ref.task.as_task("lm_tiny").model))
    assert_same_tree(got, want)


@pytest.mark.parametrize("task", ["mnist_mlp", "lm_tiny"])
def test_task_init_params_is_the_references(ref, task):
    """The server's path: ``task.init_params(key, device)`` from the host
    seed's key."""
    from repro_torch.federated.task import as_task
    seed = 1_234_567_891
    got = as_task(task).init_params(PRNGKey(seed, "cpu"), "cpu")
    want = _tree(ref, ref.task.as_task(task).init_params(
        ref.jax.random.PRNGKey(seed)))
    assert_same_tree(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_init_is_the_references(ref, arch, dtype):
    cfg = dataclasses.replace(registry.reduced(registry.get(arch)),
                              dtype=dtype)
    cfg_ref = dataclasses.replace(ref.reg.reduced(ref.reg.get(arch)),
                                  dtype=dtype)
    got = api.init(cfg, 0, device="cpu")
    want = _tree(ref, ref.api.init(cfg_ref, ref.jax.random.PRNGKey(0)))
    assert_same_tree(got, want)
    # a key is taken as it is; the int is its PRNGKey
    again = api.init(cfg, PRNGKey(0, "cpu"), device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)


# ---------------------------------------------------------------------- #
# run_experiment from the port's own init
# ---------------------------------------------------------------------- #
RUNS = {
    "mnist_mlp": (dict(), dict(n_train=3000, n_test=500, rounds=2)),
    "defended": (dict(n_ues=8, n_malicious=2, min_selected=3),
                 dict(n_train=1200, n_test=300, rounds=2,
                      scenario="sign_flip", defense="trimmed_mean")),
    "lm_tiny": (dict(n_ues=8, n_malicious=2),
                dict(task="lm_tiny", n_train=960, n_test=240, rounds=2,
                     scenario="token_flip_1to5")),
}
EXACT = ("malicious_selected", "n_rejected", "n_clipped", "n_flagged",
         "recovery_rounds", "scenario", "defense", "malicious")


@pytest.fixture(scope="module")
def run_cache():
    return {}


def _runs(cache, name):
    if name not in cache:
        cfg_kw, kw = RUNS[name]
        sim_r = reference("federated.simulation")
        cfg_r = reference("configs.base").FeelConfig(**cfg_kw)
        injected = dict(kw, task=ref_init_task(kw.get("task", "mnist_mlp")))
        cache[name] = {
            "ref": run_recorded(sim_r, cfg=cfg_r, control="host", **kw),
            "own": run_recorded(simulation, cfg=FeelConfig(**cfg_kw),
                                device="cpu", **kw),
            "injected": run_recorded(simulation, cfg=FeelConfig(**cfg_kw),
                                     device="cpu", **injected)}
    return cache[name]


@pytest.mark.parametrize("name", list(RUNS))
def test_run_from_the_ports_init_matches_the_reference(run_cache, name):
    runs = _runs(run_cache, name)
    (want, srv_r), (got, srv) = runs["ref"], runs["own"]
    assert len(srv.logs) == len(srv_r.logs) == 2
    for log, rl in zip(srv.logs, srv_r.logs):
        np.testing.assert_array_equal(log.selected, rl.selected)
        assert log.forced == rl.forced
    for f in EXACT:
        assert got[f] == want[f], f
    assert srv.rng.integers(1 << 31) == srv_r.rng.integers(1 << 31)
    for f in ("acc", "source_acc", "attack_success"):
        np.testing.assert_allclose(got[f], want[f], atol=1e-2, err_msg=f)
    if name == "lm_tiny":
        np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-3)


@pytest.mark.parametrize("name", list(RUNS))
def test_run_from_the_ports_init_equals_the_injected_run(run_cache, name):
    (own, srv), (inj, srv_i) = (_runs(run_cache, name)[k]
                                for k in ("own", "injected"))
    for a, b in zip(srv.logs, srv_i.logs):
        np.testing.assert_array_equal(a.selected, b.selected)
    for f in ("acc", "source_acc", "attack_success"):
        np.testing.assert_array_equal(own[f], inj[f], err_msg=f)
    assert srv.params.keys() == srv_i.params.keys()
    assert all(torch.equal(v, srv_i.params[k])
               for k, v in srv.params.items())
