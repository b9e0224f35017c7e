"""Port parity of the MoE zoo beyond the serving runs of
``tests/test_torch_zoo_serving.py`` (which holds the three MoE archs'
configs, prefill, caches and decode against the reference at capacity for
every token): on the reduced float32 ``qwen2-moe-a2.7b``,
``moonshot-v1-16b-a3b``, ``jamba-1.5-large-398b`` and ``deepseek-v3-671b``
with the reference's weights carried across —

- ``api.loss``: the cross-entropy, the MoE load-balance loss and
  DeepSeek's multi-token-prediction loss against the reference's
  ``metrics["ce"]``, ``metrics["aux"]`` and ``metrics["mtp_ce"]``, at the
  configs' own capacity factor (tokens dropped) and with room for all;
- serving at capacity factor 0.5, where the prefill must drop routes:
  prefill logits and 8 decode steps within 1e-4 of the reference's, so
  the same tokens were dropped;
- ``registry.optimized`` (group-local dispatch) and ``grid`` against the
  reference's, and serving an ``optimized`` config against the
  reference's;
- every MoE layer's three expert products go through ``moe_gemm`` (K5),
  at prefill and at every decode step, and nothing else does;
- the bfloat16 configs serve on the CPU with finite logits.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.configs import registry
from repro_torch.convert import flatten_tree, params_from_numpy
from repro_torch.models import api
from repro_torch.models import moe as tmoe

ARCHS = ["deepseek-v3-671b", "jamba-1.5-large-398b", "moonshot-v1-16b-a3b",
         "qwen2-moe-a2.7b"]
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, P = 2, 24, 16            # batch, full length, prefill length


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    return types.SimpleNamespace(jax=jax, jnp=jnp,
                                 reg=reference("configs.registry"),
                                 api=reference("models.api"))


def _setup(ref, arch, cf=None, groups=None):
    """Both packages' reduced float32 configs (capacity factor and
    dispatch groups set where given) and the reference's weights, as jax
    and carried into the port."""
    cfgs = []
    for reg in (ref.reg, registry):
        cfg = reg.reduced(reg.get(arch))
        moe = cfg.moe
        if cf is not None:
            moe = dataclasses.replace(moe, capacity_factor=cf)
        if groups is not None:
            moe = dataclasses.replace(moe, dispatch_groups=groups)
        cfgs.append(dataclasses.replace(cfg, dtype="float32", moe=moe))
    params_ref = ref.api.init(cfgs[0], ref.jax.random.PRNGKey(0))
    params = params_from_numpy(
        flatten_tree(ref.jax.tree.map(np.asarray, params_ref)), "cpu")
    return cfgs[0], cfgs[1], params_ref, params


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _serve(ref, cfg_ref, cfg, params_ref, params, tok):
    """Prefill P tokens, then decode the rest, in both packages: each
    step's logits compared within 1e-4."""
    jt = ref.jnp.asarray(tok, ref.jnp.int32)
    tt = torch.from_numpy(tok)
    want, cache_ref = ref.api.prefill(cfg_ref, params_ref,
                                      {"tokens": jt[:, :P]}, target_len=S)
    got, cache = api.prefill(cfg, params, {"tokens": tt[:, :P]},
                             target_len=S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for t in range(P, S):
        want, cache_ref = ref.api.decode_step(cfg_ref, params_ref, cache_ref,
                                              jt[:, t:t + 1])
        got, cache = api.decode_step(cfg, params, cache, tt[:, t:t + 1])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cf", [None, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_the_reference(ref, arch, cf):
    cfg_ref, cfg, params_ref, params = _setup(ref, arch, cf=cf)
    tok = _tokens(cfg, (B, S), seed=1)
    want, metrics = ref.api.loss(cfg_ref, params_ref,
                                 {"tokens": ref.jnp.asarray(tok,
                                                            ref.jnp.int32)})
    got, parts = api.loss(cfg, params, {"tokens": torch.from_numpy(tok)})
    assert sorted(parts) == sorted(metrics)
    assert ("mtp_ce" in parts) == cfg.mtp
    assert parts["aux"].dtype == torch.float32 and parts["aux"].dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for key in set(parts) - {"aux"}:
        np.testing.assert_allclose(parts[key].item(), float(metrics[key]),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(parts["aux"].item(), float(metrics["aux"]),
                               rtol=1e-5, atol=1e-7)
    assert parts["aux"].item() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_with_drops_matches_the_reference(ref, arch):
    """At capacity factor 0.5 the prefill's slots are fewer than its
    routes, so routes are dropped, and the port drops what the reference
    drops."""
    cfg_ref, cfg, params_ref, params = _setup(ref, arch, cf=0.5)
    tok = _tokens(cfg, (B, S), seed=2)
    routes = B * P * cfg.moe.top_k
    assert tmoe.capacity(B * P, cfg) * cfg.moe.n_routed < routes
    _serve(ref, cfg_ref, cfg, params_ref, params, tok)


def test_optimized_and_grid_match_the_reference(ref):
    for arch in registry.list_archs():
        for size in (2, 16):
            want = ref.reg.optimized(ref.reg.get(arch), size)
            got = registry.optimized(registry.get(arch), size)
            if want.moe is None:
                assert got is registry.get(arch)
            else:
                assert dataclasses.asdict(got.moe) == dataclasses.asdict(
                    want.moe)
                assert got.moe.dispatch_groups == size
    assert registry.grid() == ref.reg.grid()


@pytest.mark.parametrize("arch", ARCHS)
def test_optimized_serving_matches_the_reference(ref, arch):
    """Group-local dispatch in 2 groups at prefill (32 tokens); the decode
    steps' 2 tokens cannot fill 2 groups of top_k, so they take the global
    dispatch, in both packages."""
    cfg_ref, cfg, params_ref, params = _setup(ref, arch, cf=8.0, groups=2)
    assert cfg == registry.optimized(
        dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch_groups=0)), 2)
    _serve(ref, cfg_ref, cfg, params_ref, params,
           _tokens(cfg, (B, S), seed=3))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_expert_product_goes_through_moe_gemm(monkeypatch, arch):
    """Three ``moe_gemm`` calls a MoE layer at prefill and at each decode
    step — gate, up, then down, on the (E, G·C, ·) dispatch buffer."""
    cfg = dataclasses.replace(registry.reduced(registry.get(arch)),
                              dtype="float32")
    calls = []
    real = tmoe.moe_gemm

    def counting(x, w):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w)

    monkeypatch.setattr(tmoe, "moe_gemm", counting)
    params = api.init(cfg, 0, device="cpu")
    n_moe = cfg.n_blocks * sum(k["mlp"] == "moe"
                               for k in cfg.block_pattern())
    tok = torch.from_numpy(_tokens(cfg, (B, P + 1)))
    logits, cache = api.prefill(cfg, params, {"tokens": tok[:, :P]},
                                target_len=P + 1)
    assert len(calls) == 3 * n_moe
    E, f, d = cfg.moe.n_routed, cfg.moe.d_ff_expert, cfg.d_model
    C = tmoe.capacity(B * P, cfg)
    assert calls[:3] == [((E, C, d), (E, d, f)), ((E, C, d), (E, d, f)),
                         ((E, C, f), (E, f, d))]
    calls.clear()
    api.decode_step(cfg, params, cache, tok[:, P:])
    assert len(calls) == 3 * n_moe
    assert calls[0][0] == (E, tmoe.capacity(B, cfg), d)


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_serves_on_the_cpu(arch):
    cfg = registry.reduced(registry.get(arch))
    assert cfg.dtype == "bfloat16"
    params = api.init(cfg, 0, device="cpu")
    tok = torch.from_numpy(_tokens(cfg, (B, P + 2)))
    logits, cache = api.prefill(cfg, params, {"tokens": tok[:, :P]},
                                target_len=P + 2)
    for t in range(P, P + 2):
        step, cache = api.decode_step(cfg, params, cache, tok[:, t:t + 1])
        assert step.dtype == torch.bfloat16
        assert bool(torch.isfinite(step).all())
    assert bool(torch.isfinite(logits).all()) and cache["index"] == P + 2
