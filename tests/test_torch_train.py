"""Port parity of the zoo's training path: ``launch/steps.py``'s train
step and ``init_state``, ``models/api.py``'s ``loss(remat=)`` and
``loss_masked``, ``data/tokens.batches``, the launcher's optimizer policy,
the autograd Functions of K5 (``moe_gemm``) and K6 (``ssd_scan``), and
the two training CLIs (``launch/train.py``, ``examples/train_lm_torch.py``)
— all on the CPU, where every kernel wrapper runs its plain version.

For all ten archs reduced to float32, with the reference's ``init_state``
carried across: the loss, its metrics and every leaf's gradient against
``jax.value_and_grad`` of the reference's ``api.loss``; one optimizer
update fed the *same* (the reference's) gradients in both packages,
against the reference's; three full train steps, compared loosely (Adam's
m/√v turns a sign difference in a near-zero gradient into a step of 2·lr,
so params after several steps may differ by a few lr); remat bit-equal to
no remat; the reference's ``test_train_step_descends`` on the port.

Tolerances: the loss and metrics within 1e-5 relative (float32 sums in
another order); a leaf's gradient within 5e-5·max|its reference| (the
measured worst is 5.7e-6, DeepSeek's expert weights); params after one
update from the same gradients within 2e-6 + 2e-6·|ref|; after three
full steps within 6·lr (at most 2·lr a step for a flipped sign) and the
losses within 1e-3 relative; K5's gradients within 1e-5·max and K6's
(against the sequential recurrence) within 1e-4·max (float32, other sum
orders), each within the same bound of the reference's jax.grad.
"""
import dataclasses
import importlib.util
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.checkpoint import restore
from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import (flatten_tree, train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.data.tokens import batches, make_stream
from repro_torch.kernels import moe_gemm as k5
from repro_torch.kernels import ssd_scan as k6
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import ADAFACTOR_ARCHS
from repro_torch.launch.steps import init_state, make_train_step
from repro_torch.models import api
from repro_torch.optim import clip_by_global_norm, make_optimizer

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = registry.list_archs()
LR = 5e-3
LOSS = dict(rtol=1e-5, atol=0.0)
F32 = dict(rtol=2e-6, atol=2e-6)


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, configs=reference("configs"),
        steps=reference("launch.steps"), api=reference("models.api"),
        optim=reference("optim"), opt=reference("optim.optimizers"),
        tokens=reference("data.tokens"), mesh=reference("launch.mesh"),
        kref=reference("kernels.ref"), ssm=reference("models.ssm"))


def _opt_name(arch):
    return "adafactor" if arch in ADAFACTOR_ARCHS else "adamw"


def _batch(cfg, seed=0, b=2, s=32):
    """(the reference's batch of jnp arrays, the port's of tensors), from
    one numpy draw."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    nb = {"tokens": tok}
    if cfg.is_encoder_decoder:
        nb["src"] = rng.standard_normal((b, 16, cfg.d_model)).astype(
            np.float32)
    tb = {"tokens": torch.from_numpy(tok.astype(np.int64))}
    if "src" in nb:
        tb["src"] = torch.from_numpy(nb["src"])
    return nb, tb


def _setup(ref, arch, remat=False):
    """Both packages' reduced float32 configs and train configs, the
    reference's initial state (jax) and the same state in the port."""
    rcfg = dataclasses.replace(ref.configs.reduced(ref.configs.get(arch)),
                               dtype="float32")
    cfg = dataclasses.replace(registry.reduced(registry.get(arch)),
                              dtype="float32")
    rt = ref.configs.TrainConfig(optimizer=_opt_name(arch), lr=LR,
                                 remat=remat)
    tcfg = TrainConfig(optimizer=_opt_name(arch), lr=LR, remat=remat)
    rstate = ref.steps.init_state(rcfg, rt, ref.jax.random.PRNGKey(1))
    tstate = train_state_from_numpy(
        ref.jax.tree.map(np.asarray, rstate), "cpu")
    return rcfg, cfg, rt, tcfg, rstate, tstate


def _flat(ref, tree):
    return flatten_tree(ref.jax.tree.map(np.asarray, tree))


def _grads(cfg, params, batch, remat=False):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, metrics = api.loss(cfg, leaves, batch, remat=remat)
    g = torch.autograd.grad(loss, list(leaves.values()),
                            materialize_grads=True)
    return loss, metrics, dict(zip(leaves, g))


def test_batches_match_reference(ref):
    stream = make_stream(5_000, 97, seed=3)
    np.testing.assert_array_equal(stream, ref.tokens.make_stream(5_000, 97,
                                                                 seed=3))
    mine = batches(stream, 4, 16, np.random.default_rng(5))
    theirs = ref.tokens.batches(stream, 4, 16, np.random.default_rng(5))
    for _ in range(3):
        a, b = next(mine)["tokens"], next(theirs)["tokens"]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_launcher_policy_is_the_reference_s(ref):
    assert ADAFACTOR_ARCHS == ref.mesh.ADAFACTOR_ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(ref, arch):
    rcfg, cfg, rt, tcfg, rstate, (params, opt_state, step) = _setup(ref,
                                                                    arch)
    nb, tb = _batch(cfg)
    rb = {k: ref.jnp.asarray(v) for k, v in nb.items()}
    # the loss, its metrics and every leaf's gradient
    (rl, rm), rg = ref.jax.jit(ref.jax.value_and_grad(
        lambda p: ref.api.loss(rcfg, p, rb), has_aux=True))(rstate[0])
    loss, metrics, g = _grads(cfg, params, tb)
    np.testing.assert_allclose(float(loss.detach()), float(rl), **LOSS)
    assert set(metrics) == set(rm)
    for k in rm:
        np.testing.assert_allclose(float(torch.as_tensor(metrics[k]).detach()),
                                   float(rm[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    rgf = _flat(ref, rg)
    assert set(g) == set(rgf)
    for k, v in g.items():
        scale = np.abs(rgf[k]).max()
        np.testing.assert_allclose(v.numpy(), rgf[k], rtol=0,
                                   atol=5e-5 * scale + 1e-30, err_msg=k)
    # one update fed the reference's gradients in both packages
    want, _ = ref.jax.jit(lambda s, g: ref.optim.make_optimizer(rt).update(
        s[0], ref.opt.clip_by_global_norm(g, rt.grad_clip)[0], s[1], s[2],
        rt.lr))(rstate, rg)
    tg = {k: torch.from_numpy(np.array(v)) for k, v in rgf.items()}
    tclip, _ = clip_by_global_norm(tg, tcfg.grad_clip)
    got, _ = make_optimizer(tcfg).update(
        {k: v.clone() for k, v in params.items()}, tclip,
        {k: v.clone() for k, v in opt_state.items()}, step, tcfg.lr)
    want = _flat(ref, want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], **F32, err_msg=k)
    # three full train steps in both, each on its own gradients
    r_step = ref.jax.jit(ref.steps.make_train_step(rcfg, rt))
    t_step = make_train_step(cfg, tcfg)
    rs, ts = rstate, (params, opt_state, step)
    for _ in range(3):
        *rs, rmet = r_step(*rs, rb)
        *ts, tmet = t_step(*ts, tb)
        np.testing.assert_allclose(float(tmet["loss"]), float(rmet["loss"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(rmet["grad_norm"]), rtol=1e-3)
    assert int(ts[2]) == int(rs[2]) == 3
    rp = _flat(ref, rs[0])
    for k, v in ts[0].items():
        np.testing.assert_allclose(v.numpy(), rp[k], rtol=0, atol=6 * LR,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_equal_to_no_remat(arch):
    """On the CPU, rematerialising every block changes no bit of the
    loss, the gradients, the parameters or the optimizer state."""
    cfg = dataclasses.replace(registry.reduced(registry.get(arch)),
                              dtype="float32")
    _, tb = _batch(cfg, seed=4)
    runs = []
    for remat in (False, True):
        tcfg = TrainConfig(optimizer=_opt_name(arch), lr=LR, remat=remat)
        state = init_state(cfg, tcfg, 2, device="cpu")
        step = make_train_step(cfg, tcfg)
        losses = []
        for _ in range(2):
            *state, m = step(*state, tb)
            losses.append(m["loss"])
        runs.append((losses, state))
    (l0, s0), (l1, s1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    for a, b in zip(s0[:2], s1[:2]):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), arch


@pytest.mark.parametrize("arch", ["yi-34b", "qwen2-moe-a2.7b", "mamba2-370m",
                                  "jamba-1.5-large-398b",
                                  "deepseek-v3-671b"])
def test_loss_masked_matches_reference(ref, arch):
    rcfg, cfg, _, _, rstate, (params, _, _) = _setup(ref, arch)
    nb, tb = _batch(cfg, seed=6, b=3)
    m = np.array([1.0, 0.0, 1.0], np.float32)
    nb["m"], tb["m"] = m, torch.from_numpy(m)
    rb = {k: ref.jnp.asarray(v) for k, v in nb.items()}
    for remat in (False, True):
        (rl, rm), rg = ref.jax.jit(ref.jax.value_and_grad(
            lambda p: ref.api.loss_masked(rcfg, p, rb, remat=remat),
            has_aux=True))(rstate[0])
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss, metrics = api.loss_masked(cfg, leaves, tb, remat=remat)
        np.testing.assert_allclose(float(loss.detach()), float(rl), **LOSS)
        for k in ("ce", "aux"):
            np.testing.assert_allclose(
                float(torch.as_tensor(metrics[k]).detach()), float(rm[k]),
                rtol=1e-5, atol=1e-7)
        g = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), materialize_grads=True)))
        rgf = _flat(ref, rg)
        for k, v in g.items():
            np.testing.assert_allclose(
                v.numpy(), rgf[k], rtol=0,
                atol=5e-5 * np.abs(rgf[k]).max() + 1e-30, err_msg=k)


def test_loss_masked_refuses_an_encoder_decoder():
    cfg = registry.reduced(registry.get("seamless-m4t-medium"))
    with pytest.raises(ValueError, match="decoder-only"):
        api.loss_masked(cfg, {}, {})


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_descends(arch):
    """tests/test_models_smoke.py::test_train_step_descends on the port."""
    cfg = dataclasses.replace(registry.reduced(registry.get(arch)),
                              dtype="float32")
    tcfg = TrainConfig(optimizer="adamw", lr=5e-3, remat=False)
    params, opt_state, step = init_state(cfg, tcfg, 1, device="cpu")
    train_step = make_train_step(cfg, tcfg)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                     generator=g)}
    if cfg.is_encoder_decoder:
        batch["src"] = torch.randn(2, 16, cfg.d_model, generator=g)
    losses = []
    for _ in range(3):
        params, opt_state, step, m = train_step(params, opt_state, step,
                                                batch)
        losses.append(float(m["loss"]))
        assert torch.isfinite(m["loss"]), f"{arch}: loss blew up"
        assert torch.isfinite(m["grad_norm"])
    assert losses[-1] < losses[0], f"{arch}: loss did not decrease {losses}"
    assert int(step) == 3 and step.dtype == torch.int32


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-370m",
                                  "deepseek-v3-671b"])
def test_train_step_reads_nothing_to_the_host(monkeypatch, arch):
    """The step (loss, gradients, clipping, update) runs without a host
    read: the loss, the norm and the step come back as tensors."""
    cfg = dataclasses.replace(registry.reduced(registry.get(arch)),
                              dtype="float32")
    tcfg = TrainConfig(optimizer=_opt_name(arch), remat=True)
    state = init_state(cfg, tcfg, 0, device="cpu")
    _, tb = _batch(cfg)
    step = make_train_step(cfg, tcfg)

    def refuse(*a, **k):
        raise AssertionError("host read inside the train step")
    with monkeypatch.context() as mp:
        for name in ("item", "tolist", "numpy", "__float__", "__int__",
                     "__bool__", "cpu"):
            mp.setattr(torch.Tensor, name, refuse)
        *_, m = step(*state, tb)
    assert isinstance(m["loss"], torch.Tensor)


def test_train_state_crosses_to_the_reference_and_back(ref):
    """``train_state_to_numpy`` gives the reference's trees back, leaf for
    leaf, for AdamW, Adafactor and SGD (an empty state)."""
    for name in ("adamw", "adafactor", "sgd"):
        rcfg = dataclasses.replace(
            ref.configs.reduced(ref.configs.get("jamba-1.5-large-398b")),
            dtype="float32")
        rstate = ref.jax.tree.map(np.asarray, ref.steps.init_state(
            rcfg, ref.configs.TrainConfig(optimizer=name),
            ref.jax.random.PRNGKey(0)))
        back = train_state_to_numpy(train_state_from_numpy(rstate, "cpu"))
        want = ref.jax.tree.leaves(rstate)
        got = ref.jax.tree.leaves(back)
        assert ref.jax.tree.structure(back) == ref.jax.tree.structure(rstate)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------- #
# The autograd Functions of K5 and K6
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("E,C,K,N", [(4, 24, 16, 12), (3, 37, 20, 9),
                                     (2, 8, 33, 65)])
def test_moe_gemm_function_gradients(ref, E, C, K, N):
    """dx and dw of K5's Function against autograd through the plain
    version and against jax.grad of the reference's einsum, ragged
    capacities included; the backward is two calls of the dispatch."""
    rng = np.random.default_rng(E * C)
    x, w = (rng.standard_normal(s).astype(np.float32)
            for s in ((E, C, K), (E, K, N)))
    cot = rng.standard_normal((E, C, N)).astype(np.float32)
    calls = []
    real = k5._forward

    def counted(a, b):
        calls.append(tuple(a.shape))
        return real(a, b)
    got = []
    for fn in (k5.moe_gemm, k5.moe_gemm_ref):
        xs, ws = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(k5, "_forward", counted)
            got.append(torch.autograd.grad(fn(xs, ws), (xs, ws),
                                           torch.from_numpy(cot)))
    assert calls == [(E, C, K), (E, C, N), (E, K, C)]  # forward, dx, dw
    _, vjp = ref.jax.vjp(ref.kref.moe_gemm_ref, ref.jnp.asarray(x),
                         ref.jnp.asarray(w))
    want = vjp(ref.jnp.asarray(cot))
    for a, b, c in zip(got[0], got[1], want):
        scale = np.abs(np.asarray(c)).max()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0,
                                   atol=1e-5 * scale)
    # only the gradient asked for is computed
    calls.clear()
    xs = torch.from_numpy(x).requires_grad_(True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(k5, "_forward", counted)
        k5.moe_gemm(xs, torch.from_numpy(w)).sum().backward()
    assert calls == [(E, C, K), (E, C, N)]


def _ssd_inputs(b, length, h, p, n, g, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, length, h, p)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((b, length, h)))).astype(
                np.float32),
            -np.exp(0.2 * rng.standard_normal(h)).astype(np.float32),
            rng.standard_normal((b, length, g, n)).astype(np.float32),
            rng.standard_normal((b, length, g, n)).astype(np.float32)]


@pytest.mark.parametrize("b,length,h,p,n,g,chunk,init", [
    (2, 64, 4, 8, 16, 2, 16, False), (1, 48, 2, 16, 8, 1, 16, True),
    (1, 32, 4, 8, 8, 4, 32, True)])
def test_ssd_scan_function_gradients(ref, b, length, h, p, n, g, chunk,
                                     init):
    """The five input gradients (and the initial state's) of K6's
    Function — the chunked form's VJP — against autograd through the
    sequential recurrence (the plain version) and against jax.grad of the
    reference's ``ssd_chunked`` on B/C repeated to the heads, with
    cotangents on y and on the final state."""
    ins = _ssd_inputs(b, length, h, p, n, g, seed=length)
    rng = np.random.default_rng(1)
    s0 = rng.standard_normal((b, h, n, p)).astype(np.float32) if init \
        else None
    gy = rng.standard_normal((b, length, h, p)).astype(np.float32)
    gs = rng.standard_normal((b, h, n, p)).astype(np.float32)
    got = []
    for fn in (k6.ssd_scan, k6.ssd_scan_ref):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in ins]
        t0 = torch.from_numpy(s0).requires_grad_(True) if init else None
        y, state = fn(*ts, chunk=chunk, initial_state=t0)
        wrt = ts + ([t0] if init else [])
        got.append(torch.autograd.grad((y, state), wrt,
                                       (torch.from_numpy(gy),
                                        torch.from_numpy(gs))))
    rep = h // g

    def chunked(x, dt, A, Bm, Cm, *s):
        return ref.ssm.ssd_chunked(
            x, dt, A, ref.jnp.repeat(Bm, rep, 2), ref.jnp.repeat(Cm, rep, 2),
            chunk, initial_state=s[0] if s else None)
    args = [ref.jnp.asarray(a) for a in ins + ([s0] if init else [])]
    _, vjp = ref.jax.vjp(chunked, *args)
    want = vjp((ref.jnp.asarray(gy), ref.jnp.asarray(gs)))
    for a, b_, c in zip(got[0], got[1], want):
        scale = np.abs(np.asarray(c)).max()
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=0,
                                   atol=1e-4 * scale)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0,
                                   atol=1e-4 * scale)


def test_ssd_scan_backward_is_the_chunked_form(monkeypatch):
    """The backward recomputes ``ssd_chunked`` from the saved inputs, never
    the sequential recurrence, and an output without a cotangent (the
    final state in training) adds no work."""
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in _ssd_inputs(1, 32, 2, 8, 8, 1)]
    y, _ = k6.ssd_scan(*ts, chunk=16)
    seen = []
    real = k6.ssd_chunked

    def spy(*a, **k):
        seen.append(k.get("initial_state"))
        return real(*a, **k)
    monkeypatch.setattr(k6, "ssd_scan_ref", None)
    monkeypatch.setattr(k6, "ssd_chunked", spy)
    grads = torch.autograd.grad(y.sum(), ts)
    assert len(seen) == 1 and all(torch.isfinite(x).all() for x in grads)


# ---------------------------------------------------------------------- #
# The CLIs
# ---------------------------------------------------------------------- #
SMOKE = ["--arch", "qwen2-moe-a2.7b", "--smoke", "--batch", "2", "--seq",
         "32", "--device", "cpu"]


def test_train_cli_resumes_from_a_checkpoint(tmp_path, capsys):
    """Four steps with a checkpoint every two, then the last two again
    from the step-2 checkpoint: the restored state is the saved one bit
    for bit, and the resumed run's losses and state are the uninterrupted
    run's (the CPU is deterministic)."""
    ck = tmp_path / "ck"
    full = train_cli.main(SMOKE + ["--steps", "4", "--ckpt", str(ck),
                                   "--ckpt-every", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("device cpu  arch qwen2-moe-a2.7b-smoke  batch 2 seq "
                      "32  opt adamw")
    assert out[1].startswith("step      1 loss=") and out[-1] == "done"
    assert sorted(p.name for p in ck.iterdir()) == ["00000002", "00000004"]
    state, meta = restore(str(ck), full["state"])
    assert meta == {"step": 4}
    for a, b in zip(state[:2], full["state"][:2]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(state[2], full["state"][2])
    (ck / "00000004").rename(tmp_path / "uninterrupted_4")
    resumed = train_cli.main(SMOKE + ["--steps", "2", "--ckpt", str(ck),
                                      "--ckpt-every", "2"])
    assert "restored step 2" in capsys.readouterr().out
    assert [float(m["loss"]) for m in resumed["metrics"]] == [
        float(m["loss"]) for m in full["metrics"][2:]]
    assert int(resumed["state"][2]) == 4
    for a, b in zip(resumed["state"][:2], full["state"][:2]):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_train_cli_runs_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-370m", "--smoke", "--steps", "2", "--batch", "2", "--seq",
         "32", "--device", "cpu"], capture_output=True, text=True,
        check=True, cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                   "PATH": "/usr/bin:/bin"}).stdout
    lines = out.splitlines()
    assert lines[0].startswith("device cpu  arch mamba2-370m-smoke")
    assert lines[1].startswith("step      1 loss=")
    assert lines[2].startswith("step      2 loss=") and lines[3] == "done"


def _example():
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_trains_the_smoke_preset(capsys):
    final = _example().main(["--preset", "smoke", "--steps", "3",
                             "--batch", "2", "--seq", "32", "--device",
                             "cpu"])
    assert np.isfinite(final)
    out = capsys.readouterr().out
    assert out.startswith("arch=dense-smoke params=")
    assert "done: final loss" in out


def test_training_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.reduced(registry.get("yi-34b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(cfg, TrainConfig(), 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--arch", "yi-34b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        _example().main(["--preset", "smoke"])


def test_ssd_scan_gradient_is_finite_where_the_decay_overflows(ref):
    """ROADMAP R7: with a chunk's summed decay past e^88 the reference's
    ``ssd_chunked`` VJP is NaN (``where(causal, exp(seg), 0)`` overflows
    above the diagonal: 0·inf); the port masks before the exponent, so
    K6's Function gives the sequential recurrence's gradients there."""
    ins = _ssd_inputs(1, 512, 4, 16, 16, 1, seed=9)
    ins[1] = ins[1] + 0.5                     # dt: a chunk's decay ~ e^-300
    ts = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    got = torch.autograd.grad(k6.ssd_scan(*ts, chunk=256)[0].sum(), ts)
    ts2 = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    want = torch.autograd.grad(k6.ssd_scan_ref(*ts2, chunk=256)[0].sum(),
                               ts2)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    _, vjp = ref.jax.vjp(
        lambda *a: ref.ssm.ssd_chunked(*a, 256)[0],
        *[ref.jnp.asarray(a) for a in ins[:3]],
        *[ref.jnp.asarray(np.repeat(a, 4, 2)) for a in ins[3:]])
    ref_dt = np.asarray(vjp(ref.jnp.ones((1, 512, 4, 16)))[1])
    assert not np.isfinite(ref_dt).all()
