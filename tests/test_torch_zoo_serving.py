"""Port parity of the decoder-only zoo's serving path: the five ported
configs and their registry, ``models/api.py`` (init, prefill, decode_step,
cache_init) and ``launch/steps.py``, on the reduced float32 variants of
``starcoder2-15b``, ``yi-34b``, ``qwen2.5-32b``, ``chameleon-34b`` and
``mamba2-370m`` with the reference's ``api.init`` weights carried across
(``convert.flatten_tree``).

Within 1e-4: the prefill logits and every cache leaf, then 8 decode steps'
logits and the caches after them, against the reference's (float32; the
attention through K3's and K4's plain versions, the SSD through K6's).
Within 1e-3: prefill plus decode against the port's own full forward
(``tests/test_decode_consistency.py``'s property). The unported archs and
fields raise ``NotImplementedError``; ``api.init`` and ``api.cache_init``
default to the card and raise without one.
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
from repro_torch.models import transformer as ttr

ARCHS = ["chameleon-34b", "mamba2-370m", "qwen2.5-32b", "starcoder2-15b",
         "yi-34b"]
UNPORTED = ["deepseek-v3-671b", "jamba-1.5-large-398b",
            "moonshot-v1-16b-a3b", "qwen2-moe-a2.7b", "seamless-m4t-medium"]
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, P = 2, 32, 24            # batch, full length, prefill length


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, reg=reference("configs.registry"),
        base=reference("configs.base"), api=reference("models.api"),
        tr=reference("models.transformer"), runs={})


def _cfgs(ref, arch):
    """(the reference's reduced float32 config, the port's)."""
    return (dataclasses.replace(ref.reg.reduced(ref.reg.get(arch)),
                                dtype="float32"),
            dataclasses.replace(registry.reduced(registry.get(arch)),
                                dtype="float32"))


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
    logits, cache = ref.api.prefill(cfg_ref, params, {"tokens": jt[:, :P]},
                                    target_len=S)
    out = dict(params=_flat(ref, params), tok=tok,
               prefill=(np.asarray(logits), _flat(ref, cache)), steps=[])
    for t in range(P, S):
        logits, cache = ref.api.decode_step(cfg_ref, params, cache,
                                            jt[:, t:t + 1])
        out["steps"].append((np.asarray(logits), _flat(ref, cache)))
    ref.runs[arch] = out
    return out


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
            if f.name == "ssm" and w is not None:
                w, g = dataclasses.asdict(w), dataclasses.asdict(g)
            assert g == w, (arch, f.name)
        assert (got.head_dim, got.block_len, got.n_blocks) == (
            want.head_dim, want.block_len, want.n_blocks)
        assert got.block_pattern() == want.block_pattern()
        assert got.param_count() == want.param_count()
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


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_archs_raise(ref, arch):
    assert arch in ref.reg.list_archs()
    with pytest.raises(NotImplementedError, match="slice"):
        registry.get(arch)
    with pytest.raises(KeyError):
        registry.get("no-such-arch")


@pytest.mark.parametrize("kw", [
    dict(family="moe"), dict(family="hybrid"), dict(family="audio"),
    dict(moe=object()), dict(moe_layer_period=2), dict(mla=object()),
    dict(mtp=True), dict(first_dense_layers=1), dict(attn_layer_period=8),
    dict(is_encoder_decoder=True), dict(encoder_layers=2),
    dict(frontend="audio"), dict(frontend="vlm")])
def test_unported_fields_raise(kw):
    with pytest.raises(NotImplementedError, match="slice"):
        dataclasses.replace(registry.get("yi-34b"), **kw)


def test_ssm_family_needs_its_sub_config():
    with pytest.raises(NotImplementedError):
        dataclasses.replace(registry.get("mamba2-370m"), ssm=None)
    with pytest.raises(NotImplementedError):
        dataclasses.replace(registry.get("yi-34b"),
                            ssm=registry.get("mamba2-370m").ssm)


def test_ssm_compute_dtype_other_than_float32_raises():
    """The port's SSD computes in float32; a config asking for another
    precision raises instead of running in float32 unasked."""
    cfg = registry.get("mamba2-370m")
    with pytest.raises(NotImplementedError, match="slice"):
        dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, compute_dtype="bfloat16"))


def test_entry_points_default_to_the_card(monkeypatch):
    """Without ``device`` the zoo's entry points build on the GPU, and
    raise where CUDA is absent."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.reduced(registry.get("yi-34b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.cache_init(cfg, 1, 8)
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
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
    logits, cache = prefill(params, {"tokens": tok[:, :P]}, target_len=S)
    np.testing.assert_allclose(logits.numpy(), run["prefill"][0], **TOL)
    _close_cache(cache, run["prefill"][1])
    full = ttr.lm_forward(cfg, params, tok, window=cfg.sliding_window)
    errs = [(logits - full[:, P - 1]).abs().max().item()]
    for t, (want_logits, want_cache) in zip(range(P, S), run["steps"]):
        logits, cache = decode(params, cache, tok[:, t:t + 1])
        np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
        errs.append((logits - full[:, t]).abs().max().item())
    _close_cache(cache, run["steps"][-1][1])
    assert max(errs) < 1e-3, errs


@pytest.mark.parametrize("arch", ["mamba2-370m", "starcoder2-15b"])
def test_the_cache_crosses_both_ways(ref, arch):
    """The port decodes from the reference's prefill cache, and the
    reference from the port's, each giving the other's next logits."""
    run = _run(ref, arch)
    cfg_ref, cfg = _cfgs(ref, arch)
    params = params_from_numpy(run["params"], "cpu")
    tok = torch.from_numpy(run["tok"])
    ref_cache = unflatten_tree(run["prefill"][1])
    ref_cache["head_layers"] = ()
    logits, _ = api.decode_step(cfg, params, cache_from_numpy(ref_cache,
                                                              "cpu"),
                                tok[:, P:P + 1])
    np.testing.assert_allclose(logits.numpy(), run["steps"][0][0], **TOL)

    _, cache = api.prefill(cfg, params, {"tokens": tok[:, :P]}, target_len=S)
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
