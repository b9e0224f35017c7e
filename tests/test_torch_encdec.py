"""Port parity of the encoder-decoder (``models/encdec.py``, and
``attention.cross_attn_apply``, ``cross_attn_decode`` and ``encoder_kv``)
on the reduced float32 ``seamless-m4t-medium`` (2 encoder and 2 decoder
layers, d 256, 4 heads of 64) with the reference's parameters carried
across (``convert.flatten_tree``), and of K3's plain version on the
cross-attention's unmasked S > T:

- ``encoder_kv`` and ``cross_attn_apply`` with the target shorter than,
  equal to and longer than the source; the cross-attention of one decode
  token (``cross_attn_decode``, K4's plain version over all S_src) against
  the reference's ``cross_attn_apply`` at S = 1; ``_encode``;
- ``encdec_forward`` (logits and the encoder's output) and
  ``encdec_loss``;
- prefill of 24 target tokens after 16 source frames, then decode to 32
  (``tests/test_decode_consistency.py``'s sizes): within 1e-3 of the
  port's full forward (that test's property) and within 1e-4 of the
  reference's prefill, caches and decode steps;
- which kernel each attention takes: a prefill calls K3 three times a
  decoder layer's worth (the encoder's bidirectional self-attention, the
  decoder's causal one, the cross-attention bidirectional) and a decode
  step K4 twice a decoder layer (self and cross, the cross over
  ``length = S_src``), as ``chip_smoke.py`` counts on the card;
- K3's plain version with S > T and no mask against
  ``repro.kernels.ref.flash_attention_ref`` and the Pallas kernel in
  interpret mode; a mask with S > T still raises.

Tolerances (float32): 1e-4 absolute and relative for activations, logits,
caches and the loss (another summation order), 2e-5 for K3's plain
version against the reference's (tests/test_kernels.py's), 1e-3 for
prefill plus decode against the full forward.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.configs import registry
from repro_torch.convert import flatten_tree, params_from_numpy
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.models import api
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as ted
from repro_torch.models.common import subtree

ARCH = "seamless-m4t-medium"
TOL = dict(atol=1e-4, rtol=1e-4)
B, S_SRC, S, P = 2, 16, 32, 24     # batch, source frames, target, prefill


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, reg=reference("configs.registry"),
        api=reference("models.api"), ed=reference("models.encdec"),
        attn=reference("models.attention"), kref=reference("kernels.ref"),
        kernel=reference("kernels.flash_attention"))


@pytest.fixture(scope="module")
def model(ref):
    """Both reduced float32 configs, the reference's parameters (jax) and
    the same in the port, the target tokens and the source frames."""
    cfg_ref, cfg = (dataclasses.replace(reg.reduced(reg.get(ARCH)),
                                        dtype="float32")
                    for reg in (ref.reg, registry))
    params_ref = ref.api.init(cfg_ref, ref.jax.random.PRNGKey(0))
    flat = flatten_tree(ref.jax.tree.map(np.asarray, params_ref))
    rng = np.random.default_rng(0)
    return types.SimpleNamespace(
        cfg_ref=cfg_ref, cfg=cfg, params_ref=params_ref, flat=flat,
        params=params_from_numpy(flat, "cpu"),
        tok=rng.integers(0, cfg.vocab_size, (B, S)),
        src=rng.standard_normal((B, S_SRC, cfg.d_model)).astype(np.float32))


def _layer(m, ref_side):
    """Decoder layer 0's cross-attention params."""
    if ref_side:
        return ref_side.jax.tree.map(lambda x: x[0],
                                     m.params_ref["dec_blocks"])[
            "layers"][0]["cross"]
    return subtree(m.params, "dec_blocks/layers/0/cross/")


def _layer0(p):
    return {k: v[0] for k, v in p.items()}


def test_params_and_cache_layout_match_the_reference(ref, model):
    got = api.init(model.cfg, 0, device="cpu")
    assert sorted(got) == sorted(model.flat)
    for k, v in model.flat.items():
        assert tuple(got[k].shape) == v.shape, k
    want = flatten_tree(ref.jax.eval_shape(
        lambda: ref.api.cache_init(model.cfg_ref, B, S, src_len=S_SRC)))
    cache = api.cache_init(model.cfg, B, S, device="cpu", src_len=S_SRC)
    assert sorted(cache) == sorted(want)
    for k, w in want.items():
        if k != "index":
            assert tuple(cache[k].shape) == tuple(w.shape), k
    assert api.cache_init(model.cfg, 1, 6000, device="cpu")[
        "blocks/layers/0/xk"].shape[2] == 4096      # _default_src_len


@pytest.mark.parametrize("s_tgt", [5, S_SRC, 40])
def test_encoder_kv_and_cross_attention_match_the_reference(ref, model,
                                                            s_tgt):
    """The target shorter than, as long as and longer than the source: K3
    without a mask takes S > T."""
    jnp = ref.jnp
    p_ref = _layer(model, ref)
    p = _layer0(_layer(model, None))
    rng = np.random.default_rng(s_tgt)
    enc = rng.standard_normal((B, S_SRC, model.cfg.d_model)).astype(
        np.float32)
    x = rng.standard_normal((B, s_tgt, model.cfg.d_model)).astype(np.float32)
    k_ref, v_ref = ref.attn.encoder_kv(model.cfg_ref, p_ref, jnp.asarray(enc))
    k, v = tattn.encoder_kv(model.cfg, p, torch.from_numpy(enc))
    np.testing.assert_allclose(k.numpy(), np.asarray(k_ref), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), **TOL)
    want = ref.attn.cross_attn_apply(model.cfg_ref, p_ref, jnp.asarray(x),
                                     (k_ref, v_ref))
    got = tattn.cross_attn_apply(model.cfg, p, torch.from_numpy(x), (k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # one decode token: K4's plain version over every source position
    want = ref.attn.cross_attn_apply(model.cfg_ref, p_ref,
                                     jnp.asarray(x[:, :1]), (k_ref, v_ref))
    got = tattn.cross_attn_decode(model.cfg, p, torch.from_numpy(x[:, :1]),
                                  k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_forward_and_loss_match_the_reference(ref, model):
    jnp = ref.jnp
    src_ref, tok_ref = jnp.asarray(model.src), jnp.asarray(model.tok,
                                                           jnp.int32)
    src, tok = torch.from_numpy(model.src), torch.from_numpy(model.tok)
    enc_ref = ref.ed._encode(model.cfg_ref, model.params_ref, src_ref)
    np.testing.assert_allclose(
        ted._encode(model.cfg, model.params, src).numpy(),
        np.asarray(enc_ref), **TOL)
    logits_ref, _, _, enc_ref = ref.ed.encdec_forward(
        model.cfg_ref, model.params_ref, src_ref, tok_ref)
    logits, aux, caches, enc = ted.encdec_forward(model.cfg, model.params,
                                                  src, tok)
    assert caches is None and aux == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref), **TOL)
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_ref), **TOL)
    want, metrics = ref.api.loss(model.cfg_ref, model.params_ref,
                                 {"src": src_ref, "tokens": tok_ref})
    got, parts = api.loss(model.cfg, model.params, {"src": src,
                                                    "tokens": tok})
    assert sorted(parts) == sorted(metrics) == ["ce"]
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(parts["ce"].item(), float(metrics["ce"]),
                               **TOL)


def test_prefill_then_decode_matches_the_forward_and_the_reference(ref,
                                                                   model):
    jnp = ref.jnp
    src, tok = torch.from_numpy(model.src), torch.from_numpy(model.tok)
    full = ted.encdec_forward(model.cfg, model.params, src, tok)[0]
    logits, cache = api.prefill(model.cfg, model.params,
                                {"src": src, "tokens": tok[:, :P]},
                                target_len=S)
    want, cache_ref = ref.api.prefill(
        model.cfg_ref, model.params_ref,
        {"src": jnp.asarray(model.src),
         "tokens": jnp.asarray(model.tok[:, :P], jnp.int32)}, target_len=S)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    flat_ref = flatten_tree(ref.jax.tree.map(np.asarray, cache_ref))
    assert sorted(cache) == sorted(flat_ref)
    for k, w in flat_ref.items():
        if k == "index":
            assert cache[k] == int(w) == P
        else:
            np.testing.assert_allclose(cache[k].numpy(), w, **TOL,
                                       err_msg=k)
    errs = [(logits - full[:, P - 1]).abs().max().item()]
    for t in range(P, S):
        logits, cache = api.decode_step(model.cfg, model.params, cache,
                                        tok[:, t:t + 1])
        want, cache_ref = ref.api.decode_step(
            model.cfg_ref, model.params_ref, cache_ref,
            jnp.asarray(model.tok[:, t:t + 1], jnp.int32))
        np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)
        errs.append((logits - full[:, t]).abs().max().item())
    assert max(errs) < 1e-3, errs
    assert cache["index"] == S


def test_each_attention_takes_its_kernel(monkeypatch, model):
    """K3 at every attention of a prefill — bidirectional in the encoder
    and the cross-attention (S_src keys), causal in the decoder — and K4
    at every attention of a decode step, the cross-attention's over all
    S_src positions."""
    k3, k4 = [], []
    real3, real4 = tattn.flash_attention, tattn.decode_attention

    def count3(q, k, v, *, causal=True, window=None):
        k3.append((causal, q.shape[2], k.shape[2]))
        return real3(q, k, v, causal=causal, window=window)

    def count4(q, k, v, length):
        k4.append((k.shape[1], length))
        return real4(q, k, v, length)

    monkeypatch.setattr(tattn, "flash_attention", count3)
    monkeypatch.setattr(tattn, "decode_attention", count4)
    src, tok = torch.from_numpy(model.src), torch.from_numpy(model.tok)
    _, cache = api.prefill(model.cfg, model.params,
                           {"src": src, "tokens": tok[:, :P]}, target_len=S)
    n_enc, n_dec = model.cfg.encoder_layers, model.cfg.n_layers
    assert k3 == ([(False, S_SRC, S_SRC)] * n_enc
                  + [(True, P, P), (False, P, S_SRC)] * n_dec)
    assert k4 == []
    api.decode_step(model.cfg, model.params, cache, tok[:, P:P + 1])
    assert k4 == [(P + 1, P + 1), (S_SRC, S_SRC)] * n_dec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,t,h,hkv,d", [(64, 32, 4, 4, 64),
                                         (48, 16, 4, 2, 32),
                                         (2048 // 16, 1024 // 16, 2, 2, 64)])
def test_k3_plain_version_takes_an_unmasked_s_above_t(ref, dtype, s, t, h,
                                                      hkv, d):
    """The cross-attention of a target longer than its source: K3's plain
    version with S > T and no mask against ``flash_attention_ref`` of the
    JAX package and the Pallas kernel in interpret mode (grouped KV heads
    repeated as the reference repeats them), 2e-5 (float32) / 2e-2
    (bfloat16), tests/test_kernels.py's tolerances."""
    jnp = ref.jnp
    rng = np.random.default_rng(s + t)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, h, s, d), (2, hkv, t, d), (2, hkv, t, d)))
    tol = 2e-5 if dtype == "float32" else 2e-2
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=False).float().numpy()
    g = h // hkv
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype))
                  for a in (q, np.repeat(k, g, 1), np.repeat(v, g, 1)))
    want = ref.kref.flash_attention_ref(jq, jk, jv, causal=False)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    pallas = ref.kernel.flash_attention(jq, jk, jv, causal=False,
                                        block_q=16, block_k=16,
                                        interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,window", [(True, None), (False, 4),
                                           (True, 4)])
def test_k3_refuses_a_masked_s_above_t(causal, window):
    q, k = torch.zeros(1, 2, 9, 16), torch.zeros(1, 2, 8, 16)
    for fn in (flash_attention, flash_attention_ref):
        with pytest.raises(ValueError, match="S <= T"):
            fn(q, k, k, causal=causal, window=window)
    assert flash_attention(q, k, k, causal=False).shape == q.shape
