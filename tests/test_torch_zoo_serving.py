"""Port parity of the zoo's serving path: the ten configs and their
registry, ``models/api.py`` (init, prefill, decode_step, cache_init) and
``launch/steps.py``, on the reduced float32 variants of
``starcoder2-15b``, ``yi-34b``, ``qwen2.5-32b``, ``chameleon-34b``,
``mamba2-370m``, ``qwen2-moe-a2.7b``, ``moonshot-v1-16b-a3b``,
``jamba-1.5-large-398b``, ``deepseek-v3-671b`` (MLA, a leading dense
layer, the MTP head) and ``seamless-m4t-medium`` (the encoder-decoder,
with 16 frames of ``src``) with the reference's ``api.init`` weights
carried across (``convert.flatten_tree``). A MoE config takes capacity
factor 8.0, as ``tests/test_decode_consistency.py``'s ``_exact_cfg`` does,
so that no token is dropped and prefill plus decode can reproduce the full
forward.

Within 1e-4: the prefill logits and every cache leaf, then 8 decode steps'
logits and the caches after them, against the reference's (float32; the
attention through K3's and K4's plain versions, the SSD through K6's, the
expert products through K5's). Within 1e-3: prefill plus decode against
the port's own full forward (``tests/test_decode_consistency.py``'s
property). A field that does not fit its family raises ``ValueError`` or
``TypeError``; an unknown arch ``KeyError``; ``api.init`` and
``api.cache_init`` default to the card and raise without one.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.convert import (cache_from_numpy, cache_to_numpy,
                                 flatten_tree, params_from_numpy,
                                 unflatten_tree)
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.models import encdec as ted
from repro_torch.models import transformer as ttr
from repro_torch.random import PRNGKey

ARCHS = ["chameleon-34b", "deepseek-v3-671b", "jamba-1.5-large-398b",
         "mamba2-370m", "moonshot-v1-16b-a3b", "qwen2-moe-a2.7b",
         "qwen2.5-32b", "seamless-m4t-medium", "starcoder2-15b", "yi-34b"]
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, P = 2, 32, 24            # batch, full length, prefill length
S_SRC = 16                     # encoder frames of the encoder-decoder


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, reg=reference("configs.registry"),
        base=reference("configs.base"), api=reference("models.api"),
        tr=reference("models.transformer"), runs={})


def _cfgs(ref, arch):
    """(the reference's reduced float32 config, the port's), a MoE with
    capacity for every token."""
    out = []
    for reg in (ref.reg, registry):
        cfg = reg.reduced(reg.get(arch))
        kw = {"dtype": "float32"}
        if cfg.moe is not None:
            kw["moe"] = dataclasses.replace(cfg.moe, capacity_factor=8.0)
        out.append(dataclasses.replace(cfg, **kw))
    return tuple(out)


def _flat(ref, tree):
    return flatten_tree(ref.jax.tree.map(np.asarray, tree))


def _run(ref, arch):
    """The reference's serving run of ``arch`` (memoised per module): its
    weights, the tokens, the prefill's logits and cache, and each decode
    step's logits and cache."""
    if arch in ref.runs:
        return ref.runs[arch]
    cfg_ref, _ = _cfgs(ref, arch)
    params = ref.api.init(cfg_ref, ref.jax.random.PRNGKey(0))
    tok = np.random.default_rng(0).integers(0, cfg_ref.vocab_size, (B, S))
    jt = ref.jnp.asarray(tok, ref.jnp.int32)
    src = _src(cfg_ref)
    batch = {"tokens": jt[:, :P]}
    if src is not None:
        batch["src"] = ref.jnp.asarray(src)
    logits, cache = ref.api.prefill(cfg_ref, params, batch, target_len=S)
    out = dict(params=_flat(ref, params), tok=tok, src=src,
               prefill=(np.asarray(logits), _flat(ref, cache)), steps=[])
    for t in range(P, S):
        logits, cache = ref.api.decode_step(cfg_ref, params, cache,
                                            jt[:, t:t + 1])
        out["steps"].append((np.asarray(logits), _flat(ref, cache)))
    ref.runs[arch] = out
    return out


def _src(cfg):
    """An encoder-decoder's ``S_SRC`` frame embeddings (B, S_SRC, d)
    float32 from a seed; None for a decoder-only config."""
    if not cfg.is_encoder_decoder:
        return None
    return np.random.default_rng(1).standard_normal(
        (B, S_SRC, cfg.d_model)).astype(np.float32)


def _port_batch(run, tokens):
    batch = {"tokens": tokens}
    if run["src"] is not None:
        batch["src"] = torch.from_numpy(run["src"])
    return batch


def _full_forward(cfg, params, run, tok):
    """The port's full forward over the whole target: (B, S, V)."""
    if cfg.is_encoder_decoder:
        return ted.encdec_forward(cfg, params, torch.from_numpy(run["src"]),
                                  tok)[0]
    return ttr.lm_forward(cfg, params, tok, window=cfg.sliding_window)


def _close_cache(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if key == "index":
            assert g == int(w)
        else:
            assert tuple(g.shape) == w.shape, key
            np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=key)


# ---------------------------------------------------------------------- #
# configs
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(ref, arch):
    """Every field of the full config and of its reduced variant, the
    derived ones and the analytic parameter count."""
    for want, got in ((ref.reg.get(arch), registry.get(arch)),
                      _cfgs(ref, arch)):
        for f in dataclasses.fields(want):
            w, g = getattr(want, f.name), getattr(got, f.name)
            if f.name in ("ssm", "moe", "mla") and w is not None:
                w, g = dataclasses.asdict(w), dataclasses.asdict(g)
            assert g == w, (arch, f.name)
        assert (got.head_dim, got.block_len, got.n_blocks) == (
            want.head_dim, want.block_len, want.n_blocks)
        assert got.block_pattern() == want.block_pattern()
        for active in (False, True):
            assert got.param_count(active) == want.param_count(active)
    assert registry.list_archs() == ARCHS
    assert {k: (s.seq_len, s.global_batch, s.kind)
            for k, s in SHAPES.items()} == {
        k: (s.seq_len, s.global_batch, s.kind)
        for k, s in ref.base.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_is_within_5_percent_of_the_leaves(arch):
    cfg = registry.reduced(registry.get(arch))
    n = sum(v.numel() for v in api.init(cfg, 0, device="cpu").values())
    assert abs(cfg.param_count() - n) <= 0.05 * n


def test_unknown_arch_raises(ref):
    assert registry.list_archs() == ref.reg.list_archs()
    with pytest.raises(KeyError):
        registry.get("no-such-arch")


@pytest.mark.parametrize("arch,kw", [
    # DeepSeek's multi-token prediction and leading dense layers on a
    # dense config: the config builds and is the reference's
    ("yi-34b", dict(mtp=True)),
    ("yi-34b", dict(first_dense_layers=1)),
    ("qwen2-moe-a2.7b", dict(first_dense_layers=2, mtp=True)),
    ("deepseek-v3-671b", dict(n_layers=4)),
    ("deepseek-v3-671b", dict(mtp=False, first_dense_layers=0)),
    ("seamless-m4t-medium", dict(encoder_layers=4, n_layers=2))])
def test_deepseek_and_encdec_fields_are_admitted(ref, arch, kw):
    got = dataclasses.replace(registry.get(arch), **kw)
    want = dataclasses.replace(ref.reg.get(arch), **kw)
    assert {f.name: getattr(got, f.name) for f in dataclasses.fields(got)
            if f.name not in ("moe", "ssm", "mla")} == {
        f.name: getattr(want, f.name) for f in dataclasses.fields(want)
        if f.name not in ("moe", "ssm", "mla")}
    for active in (False, True):
        assert got.param_count(active) == want.param_count(active)


_SSM = registry.get("mamba2-370m").ssm
_MOE = registry.get("qwen2-moe-a2.7b").moe


@pytest.mark.parametrize("arch,kw,exc", [
    # the MoE and hybrid fields, ported: a sub-config that does not fit
    # its family raises at the config (the reference accepts some of
    # these silently or fails later at init)
    ("yi-34b", dict(family="moe"), ValueError),
    ("yi-34b", dict(family="hybrid"), ValueError),
    ("yi-34b", dict(moe=object()), TypeError),
    ("yi-34b", dict(moe_layer_period=2), ValueError),
    ("yi-34b", dict(attn_layer_period=8), ValueError),
    ("yi-34b", dict(family="hybrid", ssm=_SSM), ValueError),
    ("yi-34b", dict(family="hybrid", attn_layer_period=8), ValueError),
    ("qwen2-moe-a2.7b", dict(moe=None), ValueError),
    ("qwen2-moe-a2.7b", dict(ssm=_SSM), ValueError),
    ("mamba2-370m", dict(ssm=object()), TypeError),
    ("jamba-1.5-large-398b", dict(ssm=None), ValueError),
    ("jamba-1.5-large-398b", dict(attn_layer_period=0), ValueError),
    ("jamba-1.5-large-398b", dict(moe=None), ValueError),
    # the encoder-decoder, MLA and the frontends: a field that does not fit
    ("yi-34b", dict(family="audio"), ValueError),
    ("yi-34b", dict(mla=object()), TypeError),
    ("yi-34b", dict(is_encoder_decoder=True), ValueError),
    ("yi-34b", dict(encoder_layers=2), ValueError),
    ("yi-34b", dict(frontend="audio"), ValueError),
    ("yi-34b", dict(frontend="vlm"), ValueError),
    ("yi-34b", dict(family="no-such-family"), ValueError),
    ("yi-34b", dict(first_dense_layers=60), ValueError),
    ("yi-34b", dict(first_dense_layers=-1), ValueError),
    ("deepseek-v3-671b", dict(mla=registry.get("deepseek-v3-671b").moe),
     TypeError),
    ("seamless-m4t-medium", dict(encoder_layers=0), ValueError),
    ("seamless-m4t-medium", dict(is_encoder_decoder=False), ValueError),
    ("seamless-m4t-medium", dict(frontend="none"), ValueError),
    ("chameleon-34b", dict(frontend="audio"), ValueError),
])
def test_config_checks_raise(arch, kw, exc):
    with pytest.raises(exc):
        dataclasses.replace(registry.get(arch), **kw)


def test_config_checks_admit_the_families():
    """What the checks let through: a hybrid without experts, a dense
    config with a MoE (the reference's MoE every ``moe_layer_period``-th
    layer), and the derived block length (``block_len=0`` derives it
    again, as ``registry.reduced`` does)."""
    jamba = registry.get("jamba-1.5-large-398b")
    assert dataclasses.replace(jamba, moe=None, moe_layer_period=1
                               ).block_pattern()[4] == {"mixer": "attn",
                                                        "mlp": "dense"}
    cfg = dataclasses.replace(registry.get("yi-34b"), moe=_MOE,
                              moe_layer_period=2, block_len=0)
    assert cfg.block_len == 2 and [k["mlp"] for k in cfg.block_pattern()] \
        == ["dense", "moe"]


def test_ssm_family_needs_its_sub_config():
    with pytest.raises(ValueError, match="needs an SSMConfig"):
        dataclasses.replace(registry.get("mamba2-370m"), ssm=None)
    with pytest.raises(ValueError, match="family"):
        dataclasses.replace(registry.get("yi-34b"), ssm=_SSM)


def test_ssm_compute_dtype_other_than_float32_raises():
    """The port's SSD computes in float32 or, asked, in bfloat16; a config
    asking for any other precision raises instead of running in another
    one unasked."""
    cfg = registry.get("mamba2-370m")
    bf16 = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, compute_dtype="bfloat16"))
    assert bf16.ssm.compute_dtype == "bfloat16"
    for other in ("float16", "bf16", "float64"):
        with pytest.raises(ValueError, match="compute_dtype"):
            dataclasses.replace(cfg, ssm=dataclasses.replace(
                cfg.ssm, compute_dtype=other))


def test_entry_points_default_to_the_card(monkeypatch):
    """Without ``device`` the zoo's entry points build on the GPU, and
    raise where CUDA is absent."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.reduced(registry.get("yi-34b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.cache_init(cfg, 1, 8)
    params = api.init(cfg, PRNGKey(0, "cpu"), device="cpu")
    assert params["embed"].device.type == "cpu"


def test_supports_shape_matches_reference(ref):
    for arch in ARCHS:
        for name in SHAPES:
            assert (api.supports_shape(registry.get(arch), SHAPES[name])
                    == ref.api.supports_shape(ref.reg.get(arch),
                                              ref.base.SHAPES[name]))


# ---------------------------------------------------------------------- #
# serving against the reference
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(ref, arch):
    run = _run(ref, arch)
    _, cfg = _cfgs(ref, arch)
    params = params_from_numpy(run["params"], "cpu")
    tok = torch.from_numpy(run["tok"])
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    logits, cache = prefill(params, _port_batch(run, tok[:, :P]),
                            target_len=S)
    np.testing.assert_allclose(logits.numpy(), run["prefill"][0], **TOL)
    _close_cache(cache, run["prefill"][1])
    full = _full_forward(cfg, params, run, tok)
    errs = [(logits - full[:, P - 1]).abs().max().item()]
    for t, (want_logits, want_cache) in zip(range(P, S), run["steps"]):
        logits, cache = decode(params, cache, tok[:, t:t + 1])
        np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
        errs.append((logits - full[:, t]).abs().max().item())
    _close_cache(cache, run["steps"][-1][1])
    assert max(errs) < 1e-3, errs


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "jamba-1.5-large-398b",
                                  "mamba2-370m", "qwen2-moe-a2.7b",
                                  "seamless-m4t-medium", "starcoder2-15b"])
def test_the_cache_crosses_both_ways(ref, arch):
    """The port decodes from the reference's prefill cache, and the
    reference from the port's, each giving the other's next logits."""
    run = _run(ref, arch)
    cfg_ref, cfg = _cfgs(ref, arch)
    params = params_from_numpy(run["params"], "cpu")
    tok = torch.from_numpy(run["tok"])
    ref_cache = unflatten_tree(run["prefill"][1])
    if not cfg.is_encoder_decoder:
        ref_cache.setdefault("head_layers", ())
    logits, _ = api.decode_step(cfg, params, cache_from_numpy(ref_cache,
                                                              "cpu"),
                                tok[:, P:P + 1])
    np.testing.assert_allclose(logits.numpy(), run["steps"][0][0], **TOL)

    _, cache = api.prefill(cfg, params, _port_batch(run, tok[:, :P]),
                           target_len=S)
    tree = ref.jax.tree.map(ref.jnp.asarray, cache_to_numpy(cache))
    ref_params = ref.jax.tree.map(ref.jnp.asarray,
                                  unflatten_tree(run["params"]))
    want, _ = ref.api.decode_step(cfg_ref, ref_params, tree,
                                  ref.jnp.asarray(run["tok"][:, P:P + 1],
                                                  ref.jnp.int32))
    np.testing.assert_allclose(np.asarray(want), run["steps"][0][0], **TOL)


def test_cache_init_matches_the_reference(ref):
    for arch in ARCHS:
        cfg_ref, cfg = _cfgs(ref, arch)
        for seq in (8, 48):
            want = _flat(ref, ref.api.cache_init(cfg_ref, 3, seq))
            got = api.cache_init(cfg, 3, seq, device="cpu")
            _close_cache(got, want)
            if "slot_pos" in want:
                assert got["slot_pos"].dtype == torch.int32
