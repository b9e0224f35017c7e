"""Port parity of the LM model plane: ``data/tokens.py``, the ``ModelConfig``
of ``lm_tiny``, the building blocks of ``models/common.py``,
``models/attention.py``, ``models/transformer.py`` and the parameter-tree
conversion of ``convert.py``, against the JAX package on the same numpy
inputs.

Exact: the token stream (stream v2's golden anchors) and windows, the
config's derived fields, the flat keys' order against ``jax.tree.flatten``.
Within 1e-5: every float32 forward, loss, gradient and SGD epoch, each
single and on a stacked cohort of 3 clients against the reference's
``jax.vmap`` (float32 products summed in another order). The reference's
attention is its ``sdpa`` path; the port's is K3's plain version (the
CPU tensors' route through ``kernels.flash_attention``).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.convert import (flatten_tree, params_from_numpy,
                                 unflatten_tree)
from repro_torch.data import tokens as ttok
from repro_torch.federated.aggregation import flatten_stacked
from repro_torch.federated.task import LM_TINY
from repro_torch.models import attention as tatt
from repro_torch.models import common as tcom
from repro_torch.models import transformer as ttr
from repro_torch.random import PRNGKey

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, tok=reference("data.tokens"),
        com=reference("models.common"), att=reference("models.attention"),
        tr=reference("models.transformer"),
        lm=reference("federated.task").LM_TINY)


def _np_tree(ref, tree):
    return ref.jax.tree.map(np.asarray, tree)


def _ref_params(ref, seeds):
    """The reference's ``lm_init`` for each seed: (list of trees, the
    port's flat dict stacked on a leading client axis)."""
    trees = [_np_tree(ref, ref.tr.lm_init(ref.jax.random.PRNGKey(s), ref.lm))
             for s in seeds]
    flats = [flatten_tree(t) for t in trees]
    stacked = {k: torch.from_numpy(np.stack([f[k] for f in flats]))
               for k in flats[0]}
    return trees, stacked


def _stack_trees(ref, trees):
    return ref.jax.tree.map(lambda *x: ref.jnp.stack(x), *trees)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------- #
# data/tokens.py
# ---------------------------------------------------------------------- #
def test_make_stream_v2_golden(ref):
    """The anchors of tests/test_task_lm.py pin stream v2."""
    s = ttok.make_stream(200_000, 64, seed=0)
    assert s.dtype == np.int32 and s.shape == (200_000,)
    assert int(s.sum()) == 4073655
    np.testing.assert_array_equal(s[:10], [54, 17, 22, 49, 17, 2, 2, 0, 7, 1])
    np.testing.assert_array_equal(s, ref.tok.make_stream(200_000, 64, seed=0))
    assert ttok.make_stream(0, 64).size == 0


@pytest.mark.parametrize("n,vocab,seq,n_domains,seed", [
    (103, 64, 32, 10, 0), (2400, 64, 32, 10, 3), (17, 50, 9, 4, 7),
    (1, 64, 32, 10, 1)])
def test_make_windows_is_bit_equal(ref, n, vocab, seq, n_domains, seed):
    got = ttok.make_windows(n, vocab, seq, n_domains=n_domains, seed=seed)
    want = ref.tok.make_windows(n, vocab, seq, n_domains=n_domains,
                                seed=seed)
    for f in ("tokens", "y"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    sub = got.subset(np.arange(min(n, 7)))
    assert len(sub) == min(n, 7) and np.array_equal(sub.y, got.y[:len(sub)])


# ---------------------------------------------------------------------- #
# configs/base.py::ModelConfig
# ---------------------------------------------------------------------- #
def test_lm_tiny_config_matches_the_reference(ref):
    for f in dataclasses.fields(ref.lm):
        assert getattr(LM_TINY, f.name) == getattr(ref.lm, f.name), f.name
    assert (LM_TINY.head_dim, LM_TINY.block_len, LM_TINY.n_blocks) == (16, 1,
                                                                       2)
    assert LM_TINY.block_pattern() == ref.lm.block_pattern()
    assert LM_TINY.param_count() == ref.lm.param_count() == 82_240


@pytest.mark.parametrize("kw,exc", [
    # the MoE and hybrid fields are ported: on the dense LM_TINY they do
    # not fit the family and fail the config's checks
    (dict(family="moe"), ValueError), (dict(moe=object()), TypeError),
    (dict(ssm=object()), TypeError), (dict(attn_layer_period=2), ValueError),
    # MLA, the encoder-decoder and the audio frontend: an MLA sub-config
    # of the wrong type, an encoder without the encoder-decoder flag or the
    # reverse, a frontend that does not fit the family
    (dict(mla=object()), TypeError),
    (dict(is_encoder_decoder=True), ValueError),
    (dict(encoder_layers=2), ValueError),
    (dict(frontend="audio"), ValueError),
    # every layer a leading dense layer, none left to the blocks
    (dict(first_dense_layers=2), ValueError)])
def test_model_config_raises_outside_the_dense_family(kw, exc):
    with pytest.raises(exc):
        dataclasses.replace(LM_TINY, **kw)


@pytest.mark.parametrize("kw", [dict(mtp=True), dict(first_dense_layers=1)])
def test_model_config_admits_deepseek_fields(ref, kw):
    """DeepSeek's MTP head and leading dense layers on LM_TINY: the config
    builds, equals the reference's and counts its parameters alike."""
    got, want = (dataclasses.replace(c, **kw) for c in (LM_TINY, ref.lm))
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.n_blocks == want.n_blocks
    assert got.param_count() == want.param_count()


# ---------------------------------------------------------------------- #
# models/common.py
# ---------------------------------------------------------------------- #
def test_norm_rope_swiglu_cross_entropy(ref):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    _close(tcom.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           ref.com.rms_norm(ref.jnp.asarray(x), ref.jnp.asarray(scale)))
    pos = np.arange(32)
    _close(tcom.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           10_000.0),
           ref.com.apply_rope(ref.jnp.asarray(x), ref.jnp.asarray(pos)[None],
                              10_000.0))
    np.testing.assert_array_equal(tcom.rope_frequencies(16, 500.0),
                                  ref.com.rope_frequencies(16, 500.0))

    sw = _np_tree(ref, ref.com.swiglu_init(ref.jax.random.PRNGKey(1), 64,
                                           128, ref.jnp.float32))
    h = rng.standard_normal((5, 32, 64)).astype(np.float32)
    _close(tcom.swiglu_apply(params_from_numpy(sw, "cpu"),
                             torch.from_numpy(h)),
           ref.com.swiglu_apply(sw, ref.jnp.asarray(h)))

    logits = rng.standard_normal((5, 31, 64)).astype(np.float32)
    labels = rng.integers(0, 64, (5, 31))
    mask = (rng.random((5, 31)) < 0.6).astype(np.float32)
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    _close(tcom.cross_entropy(tl, tlab),
           ref.com.cross_entropy(ref.jnp.asarray(logits),
                                 ref.jnp.asarray(labels)))
    _close(tcom.cross_entropy(tl, tlab, mask=torch.from_numpy(mask)),
           ref.com.cross_entropy(ref.jnp.asarray(logits),
                                 ref.jnp.asarray(labels),
                                 mask=ref.jnp.asarray(mask)))
    # an empty mask divides by max(0, 1): loss 0
    assert float(tcom.cross_entropy(tl, tlab, mask=torch.zeros(5, 31))) == 0


def test_stacked_swiglu_and_norm_match_vmap(ref):
    rng = np.random.default_rng(1)
    sws = [_np_tree(ref, ref.com.swiglu_init(ref.jax.random.PRNGKey(s), 64,
                                             128, ref.jnp.float32))
           for s in range(3)]
    st = {k: torch.from_numpy(np.stack([s[k] for s in sws])) for k in sws[0]}
    h = rng.standard_normal((3, 4, 32, 64)).astype(np.float32)
    want = ref.jax.vmap(ref.com.swiglu_apply)(_stack_trees(ref, sws),
                                              ref.jnp.asarray(h))
    _close(tcom.swiglu_apply(st, torch.from_numpy(h)), want)
    scale = rng.standard_normal((3, 64)).astype(np.float32)
    _close(tcom.rms_norm(torch.from_numpy(h), torch.from_numpy(scale)),
           ref.jax.vmap(ref.com.rms_norm)(ref.jnp.asarray(h),
                                          ref.jnp.asarray(scale)))


# ---------------------------------------------------------------------- #
# models/attention.py
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("variant,S", [
    (dict(), 32), (dict(), 13), (dict(sliding_window=5), 32),
    (dict(qkv_bias=True, qk_norm=True), 24),
    (dict(n_kv_heads=4), 32), (dict(n_kv_heads=1), 32)])
def test_attn_apply_matches_the_reference(ref, variant, S):
    """Single and stacked (3 clients, the reference vmapped); the GQA
    repeat, RoPE, the optional QKV bias and QK-norm, a window, and an S
    that is not a multiple of 8 (the reference's Pallas guard)."""
    cfg_r = dataclasses.replace(ref.lm, **variant)
    cfg = dataclasses.replace(LM_TINY, **variant)
    rng = np.random.default_rng(2)
    ps = []
    for s in range(3):
        p = _np_tree(ref, ref.att.attn_init(ref.jax.random.PRNGKey(s),
                                            cfg_r))
        # non-zero biases and norm scales, so that both paths are used
        ps.append({k: (v + rng.standard_normal(v.shape).astype(np.float32)
                       * 0.1 if k[0] != "w" else v)
                   for k, v in p.items()})
    x = rng.standard_normal((3, 4, S, 64)).astype(np.float32)
    window = cfg.sliding_window
    got, (k, v) = tatt.attn_apply(cfg, params_from_numpy(ps[0], "cpu"),
                                  torch.from_numpy(x[0]), window=window)
    want, (kr, vr) = ref.att.attn_apply(cfg_r, ps[0], ref.jnp.asarray(x[0]),
                                        window=window)
    _close(got, want)
    _close(k, kr)
    _close(v, vr)
    st = {k: torch.from_numpy(np.stack([p[k] for p in ps])) for k in ps[0]}
    got = tatt.attn_apply(cfg, st, torch.from_numpy(x), window=window)[0]
    want = ref.jax.vmap(lambda p, xx: ref.att.attn_apply(
        cfg_r, p, xx, window=window)[0])(_stack_trees(ref, ps),
                                         ref.jnp.asarray(x))
    _close(got, want)


# ---------------------------------------------------------------------- #
# models/transformer.py
# ---------------------------------------------------------------------- #
def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(
        np.int32)


def test_lm_init_layout_matches_the_reference(ref):
    trees, _ = _ref_params(ref, [0])
    want = flatten_tree(trees[0])
    got = ttr.lm_init(PRNGKey(0, "cpu"), LM_TINY)
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.float32
    # the same draws on every call for one seed, spread like the reference
    again = ttr.lm_init(PRNGKey(0, "cpu"), LM_TINY)
    assert all(torch.equal(got[k], again[k]) for k in got)
    for k in ("embed", "lm_head", "blocks/layers/0/mixer/wq"):
        assert abs(float(got[k].std()) - float(want[k].std())) < 0.1 * float(
            want[k].std()), k
    assert torch.equal(got["final_norm"], torch.ones(64))


def test_lm_forward_matches_the_reference(ref):
    trees, stacked = _ref_params(ref, [0, 1, 2])
    toks = _tokens((3, 8, 32), 3)
    flat0 = {k: v[0] for k, v in stacked.items()}
    got = ttr.lm_forward(LM_TINY, flat0, torch.from_numpy(toks[0]).long())
    want = ref.tr.lm_forward(ref.lm, trees[0], ref.jnp.asarray(toks[0]))[0]
    assert got.shape == (8, 32, 64)
    _close(got, want)
    got = ttr.lm_forward(LM_TINY, stacked, torch.from_numpy(toks).long())
    want = ref.jax.vmap(lambda p, t: ref.tr.lm_forward(ref.lm, p, t)[0])(
        _stack_trees(ref, trees), ref.jnp.asarray(toks))
    _close(got, want)


def _masks():
    """(3, 8) per-window masks: full, half padded, fully padded."""
    m = np.ones((3, 8), np.float32)
    m[1, 4:] = 0
    m[2] = 0
    return m


def test_lm_loss_masked_and_its_gradients_match_vmap(ref):
    trees, stacked = _ref_params(ref, [0, 1, 2])
    toks, m = _tokens((3, 8, 32), 4), _masks()
    p = {k: v.clone().requires_grad_(True) for k, v in stacked.items()}
    loss = ttr.lm_loss_masked(LM_TINY, p, {
        "tokens": torch.from_numpy(toks).long(), "m": torch.from_numpy(m)})
    grads = torch.autograd.grad(loss.sum(), list(p.values()))

    def ref_loss(pp, t, mm):
        return ref.tr.lm_loss_masked(ref.lm, pp, {"tokens": t, "m": mm})[0]

    args = (_stack_trees(ref, trees), ref.jnp.asarray(toks),
            ref.jnp.asarray(m))
    _close(loss.detach(), ref.jax.vmap(ref_loss)(*args))
    want = flatten_tree(_np_tree(ref, ref.jax.vmap(ref.jax.grad(ref_loss))(
        *args)))
    for k, g in zip(p, grads):
        _close(g, want[k])
    # the fully padded client's gradient is exactly zero
    assert all(not g[2].any() for g in grads)
    # the plain loss of a full batch equals the reference's
    flat0 = {k: v[0] for k, v in stacked.items()}
    _close(ttr.lm_loss(LM_TINY, flat0,
                       {"tokens": torch.from_numpy(toks[0]).long()}),
           ref.tr.lm_loss(ref.lm, trees[0],
                          {"tokens": ref.jnp.asarray(toks[0])})[0])


def test_lm_accuracy_masked_matches_vmap(ref):
    trees, stacked = _ref_params(ref, [5, 6, 7])
    toks, m = _tokens((3, 8, 32), 5), _masks()
    got = ttr.lm_accuracy_masked(LM_TINY, stacked,
                                 torch.from_numpy(toks).long(),
                                 torch.from_numpy(m))
    want = ref.jax.vmap(lambda p, t, mm: ref.tr.lm_accuracy_masked(
        ref.lm, p, t, mm))(_stack_trees(ref, trees), ref.jnp.asarray(toks),
                           ref.jnp.asarray(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got[2]) == 0.0


def test_masked_sgd_epoch_on_a_stacked_cohort_matches_vmap(ref):
    """One masked epoch (16 windows, batch 8: a valid, a half-padded and a
    fully padded client) against the reference's vmapped epoch."""
    trees, stacked = _ref_params(ref, [0, 1, 2])
    toks = _tokens((3, 16, 32), 6)
    m = np.ones((3, 16), np.float32)
    m[1, 12:] = 0
    m[2, 8:] = 0
    got = ttr.lm_sgd_epoch_masked(LM_TINY, stacked,
                                  torch.from_numpy(toks).long(),
                                  torch.from_numpy(m), 0.3, 8)
    want = ref.jax.vmap(lambda p, t, mm: ref.tr.lm_sgd_epoch_masked(
        ref.lm, p, t, mm, 0.3, 8))(_stack_trees(ref, trees),
                                   ref.jnp.asarray(toks), ref.jnp.asarray(m))
    want = flatten_tree(_np_tree(ref, want))
    for k, v in got.items():
        _close(v, want[k])
    # the loop oracle's plain epoch over client 0 agrees too
    flat0 = {k: v[0] for k, v in stacked.items()}
    plain = ttr.lm_sgd_epoch(LM_TINY, flat0, torch.from_numpy(toks[0]).long(),
                             0.3, 8)
    for k, v in plain.items():
        _close(v, want[k][0])
    with pytest.raises(ValueError):
        ttr.lm_sgd_epoch_masked(LM_TINY, stacked,
                                torch.from_numpy(toks[:, :12]).long(),
                                torch.from_numpy(m[:, :12]), 0.3, 8)


def test_lm_loss_masked_invariant_to_padded_content(ref):
    """tests/test_task_lm.py's contract on the port: padded rows' content
    does not move the loss, and a full batch's masked loss is the plain
    loss."""
    trees, stacked = _ref_params(ref, [0])
    params = {k: v[0] for k, v in stacked.items()}
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 64, (8, 32))
    m = torch.tensor([1, 1, 1, 1, 0, 0, 0, 0], dtype=torch.float32)
    scrambled = toks.copy()
    scrambled[4:] = rng.integers(0, 64, (4, 32))
    l0 = ttr.lm_loss_masked(LM_TINY, params, {
        "tokens": torch.from_numpy(toks), "m": m})
    l1 = ttr.lm_loss_masked(LM_TINY, params, {
        "tokens": torch.from_numpy(scrambled), "m": m})
    assert float(l0) == float(l1)
    full = ttr.lm_loss(LM_TINY, params,
                       {"tokens": torch.from_numpy(toks[:4])})
    masked = ttr.lm_loss_masked(LM_TINY, params, {
        "tokens": torch.from_numpy(toks[:4]), "m": torch.ones(4)})
    np.testing.assert_allclose(float(masked), float(full), rtol=1e-6)


def test_padded_rows_have_exactly_zero_gradient(ref):
    """The masked epoch over a padded window set is bit-equal to the plain
    epoch over the real rows, and an all-padded batch leaves every
    parameter bit-unchanged."""
    _, stacked = _ref_params(ref, [1])
    params = {k: v[0] for k, v in stacked.items()}
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 64, (16, 32))
    plain = ttr.lm_sgd_epoch(LM_TINY, params, torch.from_numpy(toks), 0.3, 8)
    padded = np.concatenate([toks, rng.integers(0, 64, (8, 32))])
    m = torch.cat([torch.ones(16), torch.zeros(8)])
    masked = ttr.lm_sgd_epoch_masked(LM_TINY, params,
                                     torch.from_numpy(padded), m, 0.3, 8)
    for k in plain:
        assert torch.equal(plain[k], masked[k]), k
    same = ttr.lm_sgd_epoch_masked(LM_TINY, params,
                                   torch.from_numpy(toks[:8]),
                                   torch.zeros(8), 0.3, 8)
    for k in params:
        assert torch.equal(same[k], params[k]), k


# ---------------------------------------------------------------------- #
# convert.py
# ---------------------------------------------------------------------- #
def test_tree_round_trip_and_key_order(ref):
    """flatten_tree / unflatten_tree round-trip the reference's LM tree,
    the flat keys' sorted order is ``jax.tree.flatten``'s leaf order, and
    so ``flatten_stacked`` gives the reference's (N, 82,240) columns."""
    trees, stacked = _ref_params(ref, [0, 1])
    flat = flatten_tree(trees[0])
    back = unflatten_tree(flat)
    assert (ref.jax.tree.structure(back)
            == ref.jax.tree.structure(trees[0]))
    for a, b in zip(ref.jax.tree.leaves(back),
                    ref.jax.tree.leaves(trees[0])):
        assert a is b
    leaves = ref.jax.tree.leaves(trees[0])
    assert len(flat) == len(leaves) == 12
    assert all(flat[k] is leaf for k, leaf in zip(sorted(flat), leaves))
    cols = flatten_stacked(stacked).numpy()
    assert cols.shape == (2, 82_240)
    from jax.flatten_util import ravel_pytree
    for i, t in enumerate(trees):
        np.testing.assert_array_equal(cols[i], np.asarray(ravel_pytree(t)[0]))
    assert unflatten_tree({"a/0": 1, "a/1": 2, "b": 3}) == {"a": (1, 2),
                                                            "b": 3}
