"""Port parity of the zoo's decode loop over many steps: the sliding-window
ring cache against the linear window and against the reference's ring
(``tests/test_decode_consistency.py:45-63``), ``grow_cache`` padding only
the KV axes (``tests/test_serving_extra.py:15-23``), and greedy generation
equal to the reference's for each ported arch
(``tests/test_serving_extra.py:33-51``), on the reduced float32 variants
with the reference's weights carried across.

Tolerances: 1e-3 for a decode against the full forward (the reference's
own test's), 1e-4 against the reference's decode; greedy tokens equal.
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
from repro_torch.models import transformer as ttr

ARCHS = ["chameleon-34b", "jamba-1.5-large-398b", "mamba2-370m",
         "moonshot-v1-16b-a3b", "qwen2-moe-a2.7b", "qwen2.5-32b",
         "starcoder2-15b", "yi-34b"]


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, reg=reference("configs.registry"),
        api=reference("models.api"), tr=reference("models.transformer"))


def _setup(ref, arch, seed):
    """Both packages' reduced float32 configs, the reference's weights
    (jax) and the same carried into the port (torch)."""
    cfg_ref = dataclasses.replace(ref.reg.reduced(ref.reg.get(arch)),
                                  dtype="float32")
    cfg = dataclasses.replace(registry.reduced(registry.get(arch)),
                              dtype="float32")
    params_ref = ref.api.init(cfg_ref, ref.jax.random.PRNGKey(seed))
    params = params_from_numpy(
        flatten_tree(ref.jax.tree.map(np.asarray, params_ref)), "cpu")
    return cfg_ref, cfg, params_ref, params


def test_ring_buffer_matches_linear_window_and_reference(ref):
    """starcoder2's window (16) over 48 tokens decoded from scratch: the
    ring cache of 16 slots gives the full forward's logits (1e-3) and the
    reference's ring decode's (1e-4), with the reference's slot_pos."""
    cfg_ref, cfg, params_ref, params = _setup(ref, "starcoder2-15b", 3)
    assert cfg.sliding_window == 16
    b, s = 1, 48
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s))
    tt = torch.from_numpy(tok)
    full = ttr.lm_forward(cfg, params, tt, window=cfg.sliding_window)
    cache = api.cache_init(cfg, b, s, device="cpu")
    cache_ref = ref.api.cache_init(cfg_ref, b, s)
    assert cache["slot_pos"].shape == (16,)
    errs = []
    for t in range(s):
        logits, cache = api.decode_step(cfg, params, cache, tt[:, t:t + 1])
        want, cache_ref = ref.api.decode_step(
            cfg_ref, params_ref, cache_ref,
            ref.jnp.asarray(tok[:, t:t + 1], ref.jnp.int32))
        np.testing.assert_allclose(logits.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
        errs.append((logits - full[:, t]).abs().max().item())
    assert max(errs) < 1e-3, max(errs)
    np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                  np.asarray(cache_ref["slot_pos"]))
    assert cache["index"] == s


def test_grow_cache_pads_only_kv_axes(ref):
    cfg_ref, cfg, _, params = _setup(ref, "yi-34b", 0)
    tok = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 8)))
    logits, cache = ttr.lm_prefill(cfg, params, tok, target_len=32)
    k = cache["blocks/layers/0/k"]
    assert k.shape == (cfg.n_blocks, 1, 32, cfg.n_kv_heads, cfg.head_dim)
    assert cache["index"] == 8
    assert not k[:, :, 8:].any() and k[:, :, :8].abs().sum() > 0
    grown = ttr.grow_cache(cache, 4)
    assert grown["blocks/layers/0/v"].shape[2] == 36
    assert grown["index"] == 8
    ssm_cfg = dataclasses.replace(
        registry.reduced(registry.get("mamba2-370m")), dtype="float32")
    ssm_cache = api.cache_init(ssm_cfg, 1, 8, device="cpu")
    for key, v in ttr.grow_cache(ssm_cache, 5).items():
        assert v is ssm_cache[key], key


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generation_matches_reference(ref, arch):
    """Prefill 8 prompt tokens, then 7 greedy steps: the port's tokens are
    the reference's, and the port's own second run repeats them."""
    cfg_ref, cfg, params_ref, params = _setup(ref, arch, 0)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 8))

    def generate_port():
        logits, cache = api.prefill(cfg, params,
                                    {"tokens": torch.from_numpy(prompts)},
                                    target_len=16)
        tok = logits.argmax(-1)[:, None]
        outs = [tok]
        for _ in range(7):
            logits, cache = api.decode_step(cfg, params, cache, tok)
            tok = logits.argmax(-1)[:, None]
            outs.append(tok)
        return torch.cat(outs, 1).numpy()

    def generate_ref():
        jnp = ref.jnp
        logits, cache = ref.api.prefill(
            cfg_ref, params_ref, {"tokens": jnp.asarray(prompts, jnp.int32)},
            target_len=16)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        outs = [tok]
        for _ in range(7):
            logits, cache = ref.api.decode_step(cfg_ref, params_ref, cache,
                                                tok)
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            outs.append(tok)
        return np.asarray(jnp.concatenate(outs, 1))

    got = generate_port()
    np.testing.assert_array_equal(got, generate_ref())
    np.testing.assert_array_equal(got, generate_port())
