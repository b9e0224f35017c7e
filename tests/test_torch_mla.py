"""Port parity of DeepSeek-V3's pieces (``models/mla.py``, the leading dense
layers and the multi-token-prediction head of ``models/transformer.py``)
on the reduced float32 ``deepseek-v3-671b`` (MLA heads of 32 + 16 rope,
latent 32; 1 leading dense layer and 2 scanned MoE layers) with the
reference's parameters carried across (``convert.flatten_tree``):

- ``mla_apply`` (causal, and with a window of 5) against the reference's,
  output and the compressed cache (``c_kv``, the rotated rope key);
- ``mla_decode`` step by step from an empty cache, on a linear cache (24
  steps, also with a window) and on a ring of 8 slots (20 steps, wrapping
  twice), against the reference's decode — the outputs and the caches
  after every step, ``slot_pos`` too — and against ``mla_apply`` on the
  whole sequence;
- the compressed cache's leaf names and shapes against the reference's
  ``api.cache_init`` (the port's twin of
  ``tests/test_decode_consistency.py::test_mla_compressed_cache_is_small``:
  ``ckv`` and ``kr``, no ``k``);
- ``api.loss`` with the MTP branch (``ce``, ``mtp_ce``, ``aux``) and the
  parameter layout (``head_layers``, ``mtp``) against the reference's;
- ``launch/roofline.model_flops`` through the MLA, MTP and leading-dense
  ``param_count``: under 15% of DeepSeek's parameters active
  (``tests/test_roofline.py:46``).

Tolerances (float32): 1e-5 relative and absolute for the loss terms,
1e-4 for activations, logits and caches (another summation order in the
products); slot positions and leaf names exact.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.configs import registry
from repro_torch.convert import flatten_tree, params_from_numpy
from repro_torch.launch import roofline
from repro_torch.models import api
from repro_torch.models import mla as tmla
from repro_torch.random import PRNGKey

ARCH = "deepseek-v3-671b"
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, reg=reference("configs.registry"),
        api=reference("models.api"), mla=reference("models.mla"))


def _cfgs(ref):
    """The reference's and the port's reduced float32 DeepSeek."""
    return tuple(dataclasses.replace(reg.reduced(reg.get(ARCH)),
                                     dtype="float32")
                 for reg in (ref.reg, registry))


def _mla_params(ref, cfg_ref, seed=0):
    """(the reference's MLA params, the same in the port)."""
    p = ref.mla.mla_init(ref.jax.random.PRNGKey(seed), cfg_ref)
    flat = flatten_tree(ref.jax.tree.map(np.asarray, p))
    return p, params_from_numpy(flat, "cpu")


def _x(cfg, b, s, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def test_mla_init_layout_matches_the_reference(ref):
    cfg_ref, cfg = _cfgs(ref)
    want, _ = _mla_params(ref, cfg_ref)
    got = tmla.mla_init(PRNGKey(0, "cpu"), cfg)
    assert list(got) == list(want)          # the reference's draw order
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k


@pytest.mark.parametrize("window", [None, 5])
def test_mla_apply_matches_the_reference(ref, window):
    cfg_ref, cfg = _cfgs(ref)
    p_ref, p = _mla_params(ref, cfg_ref)
    x = _x(cfg, 3, 17)
    y_ref, (ckv_ref, kr_ref) = ref.mla.mla_apply(
        cfg_ref, p_ref, ref.jnp.asarray(x), window=window)
    y, (ckv, kr) = tmla.mla_apply(cfg, p, torch.from_numpy(x), window=window)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(ckv.numpy(), np.asarray(ckv_ref), **TOL)
    np.testing.assert_allclose(kr.numpy(), np.asarray(kr_ref), **TOL)
    assert ckv.shape == (3, 17, cfg.mla.kv_lora_rank)
    assert kr.shape == (3, 17, cfg.mla.qk_rope_head_dim)


@pytest.mark.parametrize("cache_len,steps,ring,window", [
    (24, 24, False, None),         # a linear cache
    (24, 24, False, 6),            # a window on a linear cache
    (8, 20, True, None),           # a ring of 8 slots, wrapping twice
])
def test_mla_decode_matches_the_reference(ref, cache_len, steps, ring,
                                          window):
    """Decode from an empty cache, one token a step, in both packages:
    every step's output and the caches after it; and the absorbed decode
    against the expanded full sequence (the ring and the window against
    ``mla_apply`` with the window of the ring's or the given length)."""
    cfg_ref, cfg = _cfgs(ref)
    jnp = ref.jnp
    p_ref, p = _mla_params(ref, cfg_ref, seed=1)
    b, m = 2, cfg.mla
    x = _x(cfg, b, steps, seed=2)
    ckv_ref = jnp.zeros((b, cache_len, m.kv_lora_rank))
    kr_ref = jnp.zeros((b, cache_len, m.qk_rope_head_dim))
    ckv = torch.zeros(ckv_ref.shape)
    kr = torch.zeros(kr_ref.shape)
    slot_ref = jnp.full((cache_len,), -1, jnp.int32) if ring else None
    slot = torch.full((cache_len,), -1, dtype=torch.int32) if ring else None
    ys = []
    for t in range(steps):
        y_ref, ckv_ref, kr_ref, slot_ref = ref.mla.mla_decode(
            cfg_ref, p_ref, jnp.asarray(x[:, t:t + 1]), ckv_ref, kr_ref, t,
            slot_pos=slot_ref, window=window)
        y, ckv2, kr2, slot2 = tmla.mla_decode(
            cfg, p, torch.from_numpy(x[:, t:t + 1]), ckv, kr, t,
            slot_pos=slot, window=window)
        assert ckv2 is ckv and kr2 is kr and slot2 is slot   # in place
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
        np.testing.assert_allclose(ckv.numpy(), np.asarray(ckv_ref), **TOL)
        np.testing.assert_allclose(kr.numpy(), np.asarray(kr_ref), **TOL)
        if ring:
            np.testing.assert_array_equal(slot.numpy(),
                                          np.asarray(slot_ref))
        ys.append(y)
    full, _ = tmla.mla_apply(cfg, p, torch.from_numpy(x),
                             window=cache_len if ring else window)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), full.numpy(),
                               **TOL)


def test_compressed_cache_names_and_shapes_match_the_reference(ref):
    """The MLA decode cache holds the latent and the rope key, not K/V,
    in the scanned blocks and in the leading dense layer, at the
    reference's shapes; a long_500k-length cache is a ring of the
    long-context window."""
    cfg_ref, cfg = _cfgs(ref)
    for seq in (64, 40_000):
        want = flatten_tree(ref.jax.eval_shape(
            lambda: ref.api.cache_init(cfg_ref, 1, seq)))
        got = api.cache_init(cfg, 1, seq, device="cpu")
        assert sorted(got) == sorted(want)
        names = {k.rsplit("/", 1)[-1] for k in got}
        assert {"ckv", "kr"} <= names and not names & {"k", "v"}
        for k, w in want.items():
            if k != "index":
                assert tuple(got[k].shape) == tuple(w.shape), k
                assert str(got[k].dtype) == f"torch.{w.dtype}", k
    assert got["slot_pos"].shape == (cfg.long_context_window,)
    m = cfg.mla
    assert got["blocks/layers/0/ckv"].shape == (cfg.n_blocks, 1, 16,
                                                m.kv_lora_rank)
    assert got["head_layers/0/kr"].shape == (1, 16, m.qk_rope_head_dim)


def test_loss_with_the_mtp_head_matches_the_reference(ref):
    """``api.loss`` of the reduced DeepSeek at its own capacity factor:
    the loss, ``ce``, ``mtp_ce`` and ``aux``, with the reference's
    parameter tree (``head_layers``, ``mtp``) carried across key for
    key."""
    cfg_ref, cfg = _cfgs(ref)
    params_ref = ref.api.init(cfg_ref, ref.jax.random.PRNGKey(0))
    flat = flatten_tree(ref.jax.tree.map(np.asarray, params_ref))
    mine = api.init(cfg, 0, device="cpu")
    assert sorted(mine) == sorted(flat)
    for k, v in flat.items():
        assert tuple(mine[k].shape) == v.shape, k
    assert {k.split("/")[0] for k in flat} == {
        "blocks", "embed", "final_norm", "head_layers", "lm_head", "mtp"}
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24))
    want, metrics = ref.api.loss(
        cfg_ref, params_ref, {"tokens": ref.jnp.asarray(tok, ref.jnp.int32)})
    got, parts = api.loss(cfg, params_from_numpy(flat, "cpu"),
                          {"tokens": torch.from_numpy(tok)})
    assert sorted(parts) == sorted(metrics) == ["aux", "ce", "mtp_ce"]
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for key in parts:
        np.testing.assert_allclose(parts[key].item(), float(metrics[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(
        got.item(), (parts["ce"] + 0.3 * parts["mtp_ce"]
                     + parts["aux"]).item(), rtol=1e-6)


def test_model_flops_counts_the_active_parameters(ref):
    """The roofline's model FLOPs reach the MLA, MTP and leading-dense
    terms of ``param_count``: DeepSeek-V3's active parameters are under
    15% of its 671 B, and its counts are the reference's."""
    cfg, cfg_ref = registry.get(ARCH), ref.reg.get(ARCH)
    active, total = cfg.param_count(True), cfg.param_count(False)
    assert (active, total) == (cfg_ref.param_count(True),
                               cfg_ref.param_count(False))
    assert active < 0.15 * total
    assert roofline.model_flops(cfg, 1000, train=True) == pytest.approx(
        6.0 * (active - cfg.vocab_size * cfg.d_model) * 1000)
    rl = reference("launch.roofline")
    assert roofline.model_flops(cfg, 4096, train=False) == pytest.approx(
        rl.model_flops(cfg_ref, 4096, train=False))
