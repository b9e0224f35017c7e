"""Port parity of the MoE MLP (``models/moe.py``) against the JAX package's
``repro.models.moe``, on the reduced float32 ``qwen2-moe-a2.7b`` (4
experts, top-2, one shared expert) and ``moonshot-v1-16b-a3b``, with the
reference's ``moe_init`` weights carried across.

``moe_init``'s leaves: keys, shapes, dtypes and their spread (σ = 1/√E for
``wg``/``wu``, the reference's fan-in from the first axis). ``capacity``
equal for every token count up to 4,096. ``moe_apply`` within 1e-5 of the
output's scale and its aux loss within 1e-6 for the global dispatch and for 1, 2, 4 and 8
dispatch groups, with capacity for every token and at capacity factor 0.5,
where experts overflow: equal outputs there mean the same tokens were
dropped (the stable sort). And the port's own copy of
tests/test_moe_dispatch.py's property: grouped equals global when nothing
is dropped.

The tolerance is taken against the output's scale because the
reference's draw makes that scale large: ``wg`` and ``wu`` have σ = 1/√E
(ROADMAP R4), so |y| reaches ~200 on unit inputs, and float32 products
summed in another order than XLA's differ by up to 7e-7 of it (observed);
an element near zero then carries the error of its large terms.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.configs import registry
from repro_torch.convert import flatten_tree, params_from_numpy
from repro_torch.models import moe as tmoe

ARCHS = ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"]


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    return types.SimpleNamespace(jax=jax, jnp=jnp,
                                 reg=reference("configs.registry"),
                                 moe=reference("models.moe"))


def _cfgs(ref, arch="qwen2-moe-a2.7b", cf=1.25, groups=0):
    """(the reference's reduced float32 config, the port's), capacity
    factor and dispatch groups set."""
    out = []
    for reg in (ref.reg, registry):
        cfg = reg.reduced(reg.get(arch))
        out.append(dataclasses.replace(
            cfg, dtype="float32",
            moe=dataclasses.replace(cfg.moe, capacity_factor=cf,
                                    dispatch_groups=groups)))
    return out


def _params(ref, cfg_ref, seed=0):
    p = ref.moe.moe_init(ref.jax.random.PRNGKey(seed), cfg_ref)
    return p, params_from_numpy(flatten_tree(ref.jax.tree.map(np.asarray, p)),
                                "cpu")


def _close(got, want, tol=1e-5):
    """|got - want| <= tol·max|want| + tol·|want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=tol * np.abs(want).max(), rtol=tol)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_leaves_match_the_reference(ref, arch):
    cfg_ref, cfg = _cfgs(ref, arch)
    want = flatten_tree(ref.jax.tree.map(
        np.asarray, ref.moe.moe_init(ref.jax.random.PRNGKey(0), cfg_ref)))
    got = tmoe.moe_init(torch.Generator().manual_seed(0), cfg)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
    assert got["router"].dtype == torch.float32
    m = cfg.moe
    # truncated at 3 sigma: std = 0.986·sigma; the fan-in of wg and wu is E
    for k, fan_in in (("router", cfg.d_model), ("wg", m.n_routed),
                      ("wu", m.n_routed), ("wd", m.d_ff_expert)):
        sigma = 0.98627 / np.sqrt(fan_in)
        for leaves in (got[k].numpy(), want[k]):
            assert abs(leaves.std() / sigma - 1) < 0.05, (k, leaves.std())


def test_moe_init_bfloat16_casts_the_experts_not_the_router():
    cfg = registry.reduced(registry.get("qwen2-moe-a2.7b"))
    p = tmoe.moe_init(torch.Generator().manual_seed(0), cfg)
    assert p["router"].dtype == torch.float32
    assert {p[k].dtype for k in p if k != "router"} == {torch.bfloat16}


def test_capacity_matches_the_reference(ref):
    for arch in ARCHS + ["jamba-1.5-large-398b"]:
        for cfg_ref, cfg in (_cfgs(ref, arch),
                             (ref.reg.get(arch), registry.get(arch))):
            want = [ref.moe.capacity(t, cfg_ref) for t in range(1, 4097)]
            assert [tmoe.capacity(t, cfg) for t in range(1, 4097)] == want
    assert tmoe.capacity(8 * 2048, registry.get("qwen2-moe-a2.7b")) == 1368


@pytest.mark.parametrize("groups", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("cf", [1.25, 0.5, 8.0])
def test_moe_apply_matches_the_reference(ref, cf, groups):
    """Global and group-local dispatch, with and without dropped tokens:
    outputs within 1e-5 of their scale, the aux loss within 1e-6."""
    cfg_ref, cfg = _cfgs(ref, cf=cf, groups=groups)
    p_ref, p = _params(ref, cfg_ref)
    x = _x((8, 16, cfg.d_model), seed=groups + int(cf * 10))
    y_ref, aux_ref = ref.moe.moe_apply(cfg_ref, p_ref, ref.jnp.asarray(x))
    y, aux = tmoe.moe_apply(cfg, p, torch.from_numpy(x))
    assert y.shape == x.shape and y.dtype == torch.float32
    _close(y.numpy(), y_ref)
    np.testing.assert_allclose(aux.item(), float(aux_ref), atol=1e-6,
                               rtol=1e-6)
    assert tmoe.moe_apply(cfg, p, torch.from_numpy(x),
                          with_aux=False)[1] is None


def test_drops_are_the_references_drops(ref):
    """At capacity factor 0.5 an expert overflows: the tokens that lose
    their slot contribute only the shared expert. The port's output
    without the shared expert is zero at exactly the reference's dropped
    (token, route) pairs, so the same tokens were dropped."""
    cfg_ref, cfg = _cfgs(ref, cf=0.5)
    cfg_ref = dataclasses.replace(cfg_ref, moe=dataclasses.replace(
        cfg_ref.moe, n_shared=0))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           n_shared=0))
    p_ref, p = _params(ref, cfg_ref, seed=1)
    x = _x((4, 32, cfg.d_model), seed=7)
    y_ref = np.asarray(ref.moe.moe_apply(cfg_ref, p_ref,
                                         ref.jnp.asarray(x))[0])
    y = tmoe.moe_apply(cfg, p, torch.from_numpy(x))[0].numpy()
    dropped = np.abs(y_ref).reshape(-1, cfg.d_model).max(-1) == 0
    assert dropped.any(), "capacity 0.5 should drop some token"
    np.testing.assert_array_equal(
        np.abs(y).reshape(-1, cfg.d_model).max(-1) == 0, dropped)
    _close(y, y_ref)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_grouped_equals_global_no_drops(ref, groups, seed):
    """tests/test_moe_dispatch.py's property on the port alone: with
    capacity for every token, any grouping that divides the tokens gives
    the global dispatch's output and aux loss."""
    _, cfg0 = _cfgs(ref, cf=8.0, groups=0)
    cfgg = dataclasses.replace(cfg0, moe=dataclasses.replace(
        cfg0.moe, dispatch_groups=groups))
    p = tmoe.moe_init(torch.Generator().manual_seed(0), cfg0)
    x = torch.from_numpy(_x((8, 16, cfg0.d_model), seed=100 + seed))
    y0, a0 = tmoe.moe_apply(cfg0, p, x)
    yg, ag = tmoe.moe_apply(cfgg, p, x)
    _close(yg.numpy(), y0.numpy())
    np.testing.assert_allclose(a0.item(), ag.item(), rtol=1e-5)


def test_grouped_gradients_flow():
    """tests/test_moe_dispatch.py's gradient check on the CPU route: every
    leaf gets a finite gradient, not all zero."""
    cfg = dataclasses.replace(registry.reduced(registry.get(
        "qwen2-moe-a2.7b")), dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch_groups=2))
    p = {k: v.requires_grad_(True) for k, v in tmoe.moe_init(
        torch.Generator().manual_seed(0), cfg).items()}
    x = torch.from_numpy(_x((4, 8, cfg.d_model), seed=2))
    y, aux = tmoe.moe_apply(cfg, p, x)
    grads = torch.autograd.grad(y.square().sum() + aux, list(p.values()))
    norms = [g.norm().item() for g in grads]
    assert all(np.isfinite(norms)) and sum(norms) > 0


def test_a_stacked_cohort_raises():
    cfg = registry.reduced(registry.get("qwen2-moe-a2.7b"))
    p = tmoe.moe_init(torch.Generator().manual_seed(0), cfg)
    stacked = {k: v[None] for k, v in p.items()}
    with pytest.raises(ValueError, match="dense-only"):
        tmoe.moe_apply(cfg, stacked, torch.zeros(1, 2, 4, cfg.d_model,
                                                 dtype=torch.bfloat16))
