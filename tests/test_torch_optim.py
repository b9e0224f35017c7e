"""Port parity of ``repro_torch.optim`` against ``repro.optim``: SGD,
momentum, Adam, AdamW and Adafactor over three steps on the same float32
and bfloat16 parameters, gradients and state, ``global_norm``,
``clip_by_global_norm`` and ``cosine_warmup``; the reference's rules on
the port's stacked leaves (ROADMAP R6: a stacked norm scale takes AdamW's
decay, and Adafactor factors it); and tests/test_optim.py's cases on the
port.

Tolerances: float32 parameters and moments within 2e-6 + 2e-6·|ref| (the
same float32 operations in the same order; XLA and PyTorch may round a
``pow``, a mean's sum or a square root one ulp apart); bfloat16
parameters within one bf16 ulp of the reference's (2^-7·|ref|: both round
a float32 result once, which lands on either side of a rounding boundary
when the float32 values differ by an ulp), their float32 moments as
float32.
"""
import types

import numpy as np
import pytest
import torch
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.configs.base import TrainConfig
from repro_torch.optim import (clip_by_global_norm, cosine_warmup,
                               global_norm, make_optimizer)

NAMES = ["sgd", "momentum", "adam", "adamw", "adafactor"]
# a stacked weight, a stacked norm scale, a bias, a plain matrix
SHAPES = {"blocks/layers/0/mixer/wq": (3, 8, 6),
          "blocks/layers/0/norm1": (3, 6), "final_norm": (6,),
          "lm_head": (5, 7)}
F32 = dict(rtol=2e-6, atol=2e-6)


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, optim=reference("optim"),
        opt=reference("optim.optimizers"),
        base=reference("configs.base"))


def _tcfg(cls, name):
    return cls(optimizer=name, lr=1e-2, weight_decay=0.1)


def _draw(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _nested(ref, flat, dtype):
    """The flat dict as the reference's tree of jnp arrays."""
    from repro_torch.convert import unflatten_tree
    return ref.jax.tree.map(lambda a: ref.jnp.asarray(a, dtype),
                            unflatten_tree(flat))


def _flat_np(ref, tree):
    from repro_torch.convert import flatten_tree
    return {k: np.asarray(v, np.float32)
            for k, v in flatten_tree(ref.jax.tree.map(np.asarray,
                                                      tree)).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_reference(ref, name, dtype):
    """Three updates from the same parameters with the same gradients:
    every parameter and every state leaf against the reference's."""
    jdt = getattr(ref.jnp, dtype)
    tdt = getattr(torch, dtype)
    p0 = _draw(0)
    r_opt = ref.optim.make_optimizer(_tcfg(ref.base.TrainConfig, name))
    t_opt = make_optimizer(_tcfg(TrainConfig, name))
    rp = _nested(ref, p0, jdt)
    rs = r_opt.init(rp)
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p0.items()}
    ts = t_opt.init(tp)
    tstep = torch.zeros((), dtype=torch.int32)
    for t in range(3):
        g = {k: 0.5 * v for k, v in _draw(t + 1).items()}
        rp, rs = r_opt.update(rp, _nested(ref, g, jdt), rs,
                              ref.jnp.asarray(t, ref.jnp.int32), 1e-2)
        tp, ts = t_opt.update(tp, {k: torch.from_numpy(v).to(tdt)
                                   for k, v in g.items()}, ts, tstep, 1e-2)
        tstep = tstep + 1
    want = _flat_np(ref, rp)
    assert set(want) == set(tp)
    for k, v in tp.items():
        assert v.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(v.numpy(), want[k], **F32, err_msg=k)
        else:
            np.testing.assert_allclose(v.float().numpy(), want[k],
                                       rtol=2 ** -7, atol=1e-30, err_msg=k)
    want_s = _flat_np(ref, rs)
    assert set(want_s) == set(ts)
    for k, v in ts.items():
        assert v.dtype == torch.float32, k
        np.testing.assert_allclose(v.numpy(), want_s[k], **F32, err_msg=k)


def test_global_norm_and_clip_match_reference(ref):
    g = _draw(7)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    rg = _nested(ref, g, ref.jnp.float32)
    np.testing.assert_allclose(float(global_norm(tg)),
                               float(ref.opt.global_norm(rg)), rtol=1e-6)
    for max_norm in (0.5, 1e3):            # clipped, and left as it is
        got, norm = clip_by_global_norm(tg, max_norm)
        want, rnorm = ref.opt.clip_by_global_norm(rg, max_norm)
        np.testing.assert_allclose(float(norm), float(rnorm), rtol=1e-6)
        want = _flat_np(ref, want)
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), want[k], **F32)
    # bfloat16 gradients stay bfloat16
    got, _ = clip_by_global_norm({k: v.to(torch.bfloat16)
                                  for k, v in tg.items()}, 0.5)
    assert all(v.dtype == torch.bfloat16 for v in got.values())


def test_cosine_warmup_matches_reference(ref):
    want = ref.optim.cosine_warmup(3e-4, 10, 50)
    got = cosine_warmup(3e-4, 10, 50)
    steps = np.arange(0, 60, dtype=np.float32)
    np.testing.assert_allclose(got(torch.from_numpy(steps)).numpy(),
                               np.asarray(want(ref.jnp.asarray(steps))),
                               rtol=1e-6, atol=1e-12)
    assert got(0).dtype == torch.float32
    np.testing.assert_allclose(float(got(5)), float(want(5)), rtol=1e-6)


def test_train_config_is_the_reference_s(ref):
    import dataclasses
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(
        ref.base.TrainConfig())


def test_adafactor_factors_stacked_leaves_as_the_reference_does(ref):
    """R6: a leaf of two or more axes is factored over its last two, so a
    stacked norm scale (n_blocks, d) keeps (n_blocks,) rows and (d,)
    columns; the state's keys and shapes are the reference's."""
    p = {k: torch.zeros(s) for k, s in SHAPES.items()}
    s = make_optimizer(TrainConfig(optimizer="adafactor")).init(p)
    assert s["s/blocks/layers/0/mixer/wq/vr"].shape == (3, 8)
    assert s["s/blocks/layers/0/mixer/wq/vc"].shape == (3, 6)
    assert s["s/blocks/layers/0/norm1/vr"].shape == (3,)
    assert s["s/blocks/layers/0/norm1/vc"].shape == (6,)
    assert s["s/final_norm/v"].shape == (6,)
    rs = ref.optim.make_optimizer(ref.base.TrainConfig(
        optimizer="adafactor")).init(_nested(ref, _draw(0), ref.jnp.float32))
    want = {k: v.shape for k, v in _flat_np(ref, rs).items()}
    assert {k: tuple(v.shape) for k, v in s.items()} == want


def test_adamw_decays_a_stacked_norm_as_the_reference_does():
    """R6: AdamW skips the decay on leaves of one axis only; a stacked
    norm scale has two and is decayed, a final norm is not."""
    opt = make_optimizer(TrainConfig(optimizer="adamw", weight_decay=0.1))
    p = {"blocks/layers/0/norm1": torch.ones(3, 6),
         "final_norm": torch.ones(6)}
    new, _ = opt.update(p, {k: torch.zeros_like(v) for k, v in p.items()},
                        opt.init(p), torch.zeros((), dtype=torch.int32), 0.5)
    assert bool((new["blocks/layers/0/norm1"] < 1.0).all())
    assert torch.equal(new["final_norm"], torch.ones(6))


def test_update_reads_nothing_to_the_host(monkeypatch):
    """Every optimizer's update, clipping and the schedule run on device
    tensors without a host read (the step stays a tensor)."""
    p = {k: torch.randn(s) for k, s in SHAPES.items()}
    g = {k: torch.randn(s) for k, s in SHAPES.items()}
    opts = [make_optimizer(TrainConfig(optimizer=n)) for n in NAMES]
    states = [o.init(p) for o in opts]

    def refuse(*a, **k):
        raise AssertionError("host read")
    for name in ("item", "tolist", "numpy", "__float__", "__int__",
                 "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    step = torch.zeros((), dtype=torch.int32)
    for o, s in zip(opts, states):
        o.update(p, g, s, step, 1e-3)
    clip_by_global_norm(g, 1.0)
    cosine_warmup(1e-3, 10, 100)(step)


# ---------------------------------------------------------------------- #
# tests/test_optim.py's cases, on the port
# ---------------------------------------------------------------------- #
def _quadratic(params):
    return sum(torch.sum(torch.square(x)) for x in params.values())


def _fit(opt_name, steps=60, lr=0.1):
    opt = make_optimizer(TrainConfig(optimizer=opt_name, lr=lr,
                                     weight_decay=0.0))
    params = {"w": torch.tensor([[1.0, -2.0], [3.0, 0.5]]),
              "b": torch.tensor([4.0, -4.0])}
    state = opt.init(params)
    for t in range(steps):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        g = dict(zip(leaves, torch.autograd.grad(_quadratic(leaves),
                                                 list(leaves.values()))))
        with torch.no_grad():
            params, state = opt.update(params, g, state,
                                       torch.tensor(t, dtype=torch.int32), lr)
    return float(_quadratic(params))


@pytest.mark.parametrize("name", NAMES)
def test_descent(name):
    assert _fit(name) < 0.3


def test_adam_matches_reference_step():
    opt = make_optimizer(TrainConfig(optimizer="adam", beta1=0.9,
                                     beta2=0.999, eps=1e-8))
    p = {"w": torch.tensor([1.0])}
    new, _ = opt.update(p, {"w": torch.tensor([0.5])}, opt.init(p),
                        torch.tensor(0, dtype=torch.int32), 0.01)
    expect = 1.0 - 0.01 * 0.5 / (np.sqrt(0.25) + 1e-8)
    np.testing.assert_allclose(new["w"].numpy(), [expect], rtol=1e-5)


def test_adamw_decays_matrices_only():
    opt = make_optimizer(TrainConfig(optimizer="adamw", weight_decay=0.1))
    p = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    new, _ = opt.update(p, {k: torch.zeros_like(v) for k, v in p.items()},
                        opt.init(p), torch.tensor(0, dtype=torch.int32), 0.5)
    assert bool((new["w"] < 1.0).all())
    np.testing.assert_allclose(new["b"].numpy(), 1.0)


def test_adafactor_state_is_factored():
    p = {"w": torch.zeros(64, 32), "b": torch.zeros(64)}
    s = make_optimizer(TrainConfig(optimizer="adafactor")).init(p)
    assert s["s/w/vr"].shape == (64,)
    assert s["s/w/vc"].shape == (32,)
    assert s["s/b/v"].shape == (64,)
    assert sum(x.numel() for x in s.values()) < p["w"].numel()


def test_grad_clip():
    g = {"a": torch.full((10,), 3.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)
    np.testing.assert_allclose(float(norm), np.sqrt(90.0), rtol=1e-5)


def test_unknown_optimizer_raises():
    with pytest.raises(KeyError, match="unknown optimizer"):
        make_optimizer(TrainConfig(optimizer="lion"))
