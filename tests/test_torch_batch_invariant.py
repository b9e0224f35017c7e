"""The task plane's batch-invariant route (``models/batch_invariant.py``)
and its two kernels' plain versions (``kernels/bi_gemm.py``,
``kernels/bi_reduce.py``), on the CPU.

On the CPU the route is the torch expressions the task plane always ran:
``bi_gemm_ref`` and ``bi_reduce_ref`` are bit-equal to the torch ops they
stand for, and the losses (tensor quotients on the route) bit-equal to
their masked twins. The kernel route itself runs here with the kernels'
plain versions in place of the kernels (``forced``: ``bi.on`` made true
for CPU tensors inside the route): a client's slice of a stack of N is
bit-equal to its unstacked call, one stacked masked SGD step equals the
loop oracle's step client for client, and the route's hand-written
backwards (products, broadcast sums, logsumexp, the picked logit, the
one-hot embedding gradient, K3's VJP) agree with torch's autograd of the
plain path; a routed step or evaluation runs no torch product or
reduction (``bi.TORCH_SUMS``), nor does a routed backward run by another
thread, as CUDA's autograd runs it. The plain versions are held against
the reference's jnp ops.
"""
from __future__ import annotations

import collections
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch_parity import single_threaded  # noqa: F401

from repro_torch.federated import cohort
from repro_torch.federated.task import LM_TINY, LmTask, MnistTask
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels.bi_gemm import bi_gemm, bi_gemm_ref
from repro_torch.kernels.bi_reduce import (ARGMAX, LOGSUMEXP, SUM, bi_reduce,
                                           bi_reduce_ref)
from repro_torch.models import batch_invariant as bi
from repro_torch.models import common, mlp, transformer
from repro_torch.models.common import sgd_step
from repro_torch.random import PRNGKey


def _rand(*shape, seed=0):
    g = np.random.default_rng(seed + 7 * sum(shape))
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32))


@pytest.fixture
def forced(monkeypatch):
    """The kernel route on CPU tensors: ``bi.on`` true inside ``route()``
    whatever the device, so the route's Functions run on the kernels'
    plain versions."""
    monkeypatch.setattr(bi, "on", lambda x: bi._active())
    return bi.route


def _stack(params, n):
    return {k: v.expand((n,) + v.shape).clone() for k, v in params.items()}


def _mlp_params():
    return mlp.mlp_init(PRNGKey(0, "cpu"), device="cpu")


def _lm_params():
    return transformer.lm_init(PRNGKey(1, "cpu"), LM_TINY, device="cpu")


# ---------------------------------------------------------------------- #
# 1. the plain versions are the torch ops they stand for
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("ba,bb,m,k,n", [
    (1, 1, 50, 784, 64), (4, 4, 50, 784, 64), (1, 3, 37, 29, 11),
    (3, 3, 256, 64, 128), (2, 2, 3, 4, 5)])
def test_bi_gemm_ref_is_torch_matmul(ba, bb, m, k, n):
    a, b = _rand(ba, m, k), _rand(bb, k, n, seed=1)
    want = torch.matmul(a, b)
    assert torch.equal(bi_gemm_ref(a, b), want)
    assert torch.equal(bi_gemm(a, b), want)          # the CPU route
    # a transposed operand is a strided view
    assert torch.equal(bi_gemm(a.mT.contiguous().mT, b),
                       torch.matmul(a.mT.contiguous().mT, b))


@pytest.mark.parametrize("shape,keep", [((3, 8, 31), 1), ((50, 10), 1),
                                        ((4, 5, 64), 2), ((2, 6, 7, 3), 1)])
def test_bi_reduce_ref_is_torch_sum_logsumexp_argmax(shape, keep):
    x = _rand(*shape)
    r = int(np.prod(shape[:keep]))
    dims = tuple(range(keep, len(shape)))
    assert torch.equal(bi_reduce_ref(x.reshape(r, -1, 1), SUM).reshape(
        shape[:keep]), x.sum(dims))
    assert torch.equal(bi_reduce(x.reshape(r, -1, 1)).reshape(shape[:keep]),
                       x.sum(dims))
    last = x.reshape(-1, shape[-1], 1)
    assert torch.equal(bi_reduce_ref(last, LOGSUMEXP).reshape(shape[:-1]),
                       torch.logsumexp(x, -1))
    assert torch.equal(bi_reduce_ref(last, ARGMAX).reshape(shape[:-1]),
                       torch.argmax(x, -1))
    # a middle axis (a broadcast operand's gradient)
    if len(shape) == 3:
        assert torch.equal(bi_reduce_ref(x, SUM), x.sum(1))


def test_plain_versions_agree_with_the_reference_jnp_ops():
    import jax.numpy as jnp
    import jax.scipy.special as jss
    a, b = _rand(3, 50, 784), _rand(3, 784, 64, seed=2)
    np.testing.assert_allclose(
        bi_gemm(a, b).numpy(), np.asarray(jnp.matmul(a.numpy(), b.numpy())),
        rtol=1e-5, atol=1e-4)
    x = _rand(6, 31, 64)
    np.testing.assert_allclose(
        bi_reduce(x.reshape(6, -1, 1)).reshape(6).numpy(),
        np.asarray(jnp.sum(x.numpy(), (1, 2))), rtol=1e-5, atol=1e-4)
    last = x.reshape(-1, 64, 1)
    np.testing.assert_allclose(
        bi_reduce(last, LOGSUMEXP).reshape(6, 31).numpy(),
        np.asarray(jss.logsumexp(x.numpy(), -1)), rtol=1e-6, atol=1e-6)
    assert np.array_equal(bi_reduce(last, ARGMAX).reshape(6, 31).numpy(),
                          np.asarray(jnp.argmax(x.numpy(), -1)))


def test_the_operators_on_meta_tensors():
    """The dispatcher's fake implementations make the outputs' shapes and
    dtypes and count no launch."""
    a = torch.empty(1, 7, 5, device="meta")
    b = torch.empty(4, 5, 3, device="meta")
    before = (bi_gemm.launches, bi_reduce.launches)
    out = bi_gemm(a, b)
    assert out.shape == (4, 7, 3) and out.device.type == "meta"
    x = torch.empty(6, 9, 2, device="meta")
    assert bi_reduce(x).shape == (6, 2)
    am = bi_reduce(torch.empty(6, 9, 1, device="meta"), ARGMAX)
    assert am.shape == (6, 1) and am.dtype == torch.int64
    assert (bi_gemm.launches, bi_reduce.launches) == before


@pytest.mark.parametrize("bad", [
    lambda: bi_gemm(_rand(2, 3, 4), _rand(3, 4, 5)),
    lambda: bi_gemm(_rand(2, 3, 4), _rand(2, 5, 5)),
    lambda: bi_gemm(_rand(2, 3, 4).double(), _rand(2, 4, 5).double()),
    lambda: bi_reduce(_rand(3, 4, 2), LOGSUMEXP),
    lambda: bi_reduce(_rand(3, 4), SUM),
    lambda: bi_reduce(_rand(3, 4, 1), 7)])
def test_the_wrappers_refuse_what_the_kernels_do_not_take(bad):
    with pytest.raises((ValueError, TypeError)):
        bad()


# ---------------------------------------------------------------------- #
# 2. the route is the task plane's, and the CPU's numbers are today's
# ---------------------------------------------------------------------- #
def test_the_route_is_scoped_to_the_task_plane():
    x = torch.zeros(2)
    assert not bi.on(x)
    with bi.route():
        assert not bi.on(x)                 # a CPU tensor: the plain ops
        assert bi._active()
        with bi.route():
            assert bi._active()
        assert bi._active()
    assert not bi._active()
    # the task plane's methods and the two evaluations enter the route
    for task in (MnistTask(), LmTask()):
        for name in ("sgd_epoch", "local_metric", "predict_units",
                     "eval_loss", "local_train", "eval_units_loop",
                     "global_metrics"):
            assert getattr(task, name).__wrapped__ is not None, name
    for fn in (cohort.cohort_eval, cohort.cohort_eval_rows):
        assert fn.__wrapped__ is not None


@pytest.mark.parametrize("route", [False, True])
def test_losses_equal_their_masked_twins_at_an_all_ones_mask(route,
                                                             forced):
    """mlp_loss and lm_loss (a quotient by a count tensor on the route)
    equal mlp_loss_masked and lm_loss_masked at an all-ones mask, bit for
    bit, on the CPU's path and on the kernel route."""
    p, lp = _mlp_params(), _lm_params()
    x, y = _rand(50, 784).abs(), torch.arange(50) % 10
    tokens = torch.as_tensor(np.random.default_rng(3).integers(0, 64,
                                                               (8, 32)))
    ctx = forced() if route else _Null()
    with ctx:
        a = mlp.mlp_loss(p, {"x": x, "y": y})
        b = mlp.mlp_loss_masked(p, {"x": x, "y": y, "m": torch.ones(50)})
        c = transformer.lm_loss(LM_TINY, lp, {"tokens": tokens})
        d = transformer.lm_loss_masked(LM_TINY, lp, {"tokens": tokens,
                                                     "m": torch.ones(8)})
    assert torch.equal(a, b) and torch.equal(c, d)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_the_mean_as_a_tensor_quotient_is_the_cpu_mean():
    for shape in ((50,), (8, 31), (3, 8, 31), (7, 10)):
        x = _rand(*shape)
        keep = 1 if len(shape) == 3 else 0
        dims = tuple(range(keep, len(shape)))
        assert torch.equal(x.mean(dims), x.sum(dims) / bi.count(x, keep))


# ---------------------------------------------------------------------- #
# 3. a client's slice of a stack of N is its unstacked call
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [1, 2, 8])
def test_stacked_slices_equal_the_unstacked_call(n, forced):
    p, lp = _mlp_params(), _lm_params()
    xs = _rand(n, 50, 784).abs()
    tok = torch.as_tensor(np.random.default_rng(4).integers(0, 64,
                                                            (n, 8, 32)))
    with forced():
        out = mlp.mlp_apply(_stack(p, n), xs)
        shared = mlp.mlp_apply(_stack(p, n), xs[0])
        lm = transformer.lm_forward(LM_TINY, _stack(lp, n), tok)
        h = _rand(n, 8, 32, 64)
        norm = common.rms_norm(h, _rand(n, 64, seed=5))
        nll = common.cross_entropy(lm[..., :-1, :], tok[..., 1:], keep=1)
        am = bi.argmax(lm)
        for i in range(n):
            assert torch.equal(out[i], mlp.mlp_apply(p, xs[i]))
            assert torch.equal(shared[i], mlp.mlp_apply(p, xs[0]))
            assert torch.equal(lm[i], transformer.lm_forward(LM_TINY, lp,
                                                             tok[i]))
            assert torch.equal(norm[i], common.rms_norm(
                h[i], _rand(n, 64, seed=5)[i]))
            assert torch.equal(nll[i], common.cross_entropy(
                lm[i, :, :-1], tok[i, :, 1:]))
            assert torch.equal(am[i], bi.argmax(lm[i]))


def _grads(loss_fn, params):
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(p)
    return dict(zip(p, torch.autograd.grad(loss, list(p.values()),
                                           torch.ones_like(loss))))


@pytest.mark.parametrize("route", [False, True])
@pytest.mark.parametrize("model", ["mlp", "lm"])
def test_one_stacked_masked_step_is_the_loop_step(model, route, forced):
    """One masked SGD step of a stack of 8 clients equals, client for
    client, local_train's step of the client alone (a client with fewer
    samples than the batch padded with zero-mask rows); on the CPU's path
    and on the kernel route."""
    n, g = 8, np.random.default_rng(6)
    ctx = forced() if route else _Null()
    if model == "mlp":
        params, size, lr = _mlp_params(), 50, 0.1
        x = torch.as_tensor(g.random((n, size, 784), dtype=np.float32))
        y = torch.as_tensor(g.integers(0, 10, (n, size)))
        valid = [size] * (n - 1) + [size - 17]
        m = torch.stack([(torch.arange(size) < v).float() for v in valid])
        with ctx:
            stacked = sgd_step(_stack(params, n),
                               lambda p: mlp.mlp_loss_masked(
                                   p, {"x": x, "y": y, "m": m}), lr)
            for i, v in enumerate(valid):
                one = sgd_step(params, lambda p: mlp.mlp_loss(
                    p, {"x": x[i, :v], "y": y[i, :v]}), lr)
                for k in one:
                    assert torch.equal(stacked[k][i], one[k]), (i, k)
    else:
        params, size, lr = _lm_params(), 8, 0.3
        tok = torch.as_tensor(g.integers(0, 64, (n, size, 32)))
        valid = [size] * (n - 1) + [5]
        m = torch.stack([(torch.arange(size) < v).float() for v in valid])
        with ctx:
            stacked = sgd_step(_stack(params, n),
                               lambda p: transformer.lm_loss_masked(
                                   LM_TINY, p, {"tokens": tok, "m": m}), lr)
            for i, v in enumerate(valid):
                one = sgd_step(params, lambda p: transformer.lm_loss(
                    LM_TINY, p, {"tokens": tok[i, :v]}), lr)
                for k in one:
                    assert torch.equal(stacked[k][i], one[k]), (i, k)


# ---------------------------------------------------------------------- #
# 4. the route's backwards against torch's autograd of the plain path
# ---------------------------------------------------------------------- #
def _close(a, b, tol):
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=tol,
                                   atol=tol, err_msg=k)


def test_the_routes_gradients_are_autograds(forced):
    p, lp = _mlp_params(), _lm_params()
    x, y = _rand(3, 50, 784).abs(), torch.arange(150).reshape(3, 50) % 10
    m = torch.ones(3, 50)
    tok = torch.as_tensor(np.random.default_rng(7).integers(0, 64, (3, 8, 32)))
    mt = torch.tensor([[1.0] * 8, [1.0] * 8, [1.0] * 5 + [0.0] * 3])

    def mlp_loss(q):
        return mlp.mlp_loss_masked(q, {"x": x, "y": y, "m": m})

    def lm_loss(q):
        return transformer.lm_loss_masked(LM_TINY, q, {"tokens": tok,
                                                       "m": mt})
    plain_m, plain_l = _grads(mlp_loss, _stack(p, 3)), _grads(lm_loss,
                                                                 _stack(lp, 3))
    with forced():
        route_m = _grads(mlp_loss, _stack(p, 3))
        route_l = _grads(lm_loss, _stack(lp, 3))
    _close(route_m, plain_m, 1e-6)
    _close(route_l, plain_l, 2e-6)


@pytest.mark.parametrize("causal,window,hkv", [(True, None, 2),
                                               (True, 8, 4),
                                               (False, None, 1)])
def test_k3s_invariant_vjp_is_the_plain_vjp(causal, window, hkv):
    q, g = _rand(3, 4, 16, 16), _rand(3, 4, 16, 16, seed=2)
    k, v = _rand(3, hkv, 16, 16, seed=3), _rand(3, hkv, 16, 16, seed=4)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = k3.flash_attention_ref(*qkv, causal=causal, window=window)
    want = torch.autograd.grad(out, qkv, g)
    got = bi.invariant_vjp(q, k, v, g, causal, window, 16 ** -0.5)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def _infinite_max_inputs():
    """chip_smoke.py's ``infinite_max_inputs``: the NLL's logits with a
    +inf off and at the label, a row of -inf and -inf among finite
    values; an attention's q, k, v, g whose scores hold +-inf (head 0)
    and a row of -inf (head 1)."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((5, 10)).astype(np.float32)
    logits[1, 3] = logits[3, 4] = np.inf
    logits[2] = -np.inf
    logits[4, ::2] = -np.inf
    labels = np.array([0, 1, 2, 4, 1])
    rng = np.random.default_rng(1)
    q, k, v, g = (rng.standard_normal((1, 2, 4, 8)).astype(np.float32)
                  for _ in range(4))
    k[0, 0, 2, 0] = np.inf
    q[0, 0, :, 0] = [1.0, -1.0, 2.0, 0.5]
    k[0, 1, :, 0] = np.inf
    q[0, 1, :, 0] = [1.0, -1.0, 1.0, 1.0]
    return logits, labels, q, k, v, g


def _nan_and_close(got, want, label):
    """NaN exactly where ``want`` is NaN, +-inf where it is, the rest
    within 1e-6 · max(1, |want|)."""
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), label
    inf = np.isinf(want)
    assert np.array_equal(got[inf], want[inf]), label
    fin = ~nan & ~inf
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-6 * max(
        1.0, float(np.abs(want[fin]).max(initial=0.0))), err_msg=label)


@pytest.mark.parametrize("lse", ["plain", "kernel_order"])
@pytest.mark.parametrize("op", ["nll", "attention"])
def test_an_infinite_maximum_backward_against_jax_grad(forced, monkeypatch,
                                                       op, lse):
    """The route's NLL and attention backward on rows whose maximum is
    +-inf, against ``jax.grad`` of the reference's loss
    (``jax.scipy.special.logsumexp`` of the logits less the picked one)
    and ``jax.vjp`` of its attention oracle (``kernels/ref.py``), with
    ``bi_reduce``'s logsumexp its plain version (``torch.logsumexp``, the
    CPU's) or its kernel's order (``bi_logsumexp_chain_ref``, the card's):
    the NLL and its gradient NaN where jax's are NaN and within 1e-6
    elsewhere; attention's dq and dk too, and its dv NaN on every key, as
    jax's softmax is NaN across a row whose maximum is +inf (ROADMAP P30,
    closed: ``invariant_vjp`` adds lse - lse to p, which is NaN on such a
    row and +0 on every other)."""
    from torch_parity import reference
    import jax
    import jax.numpy as jnp

    from repro_torch.kernels import bi_reduce as kbr
    if lse == "kernel_order":
        real = kbr.bi_reduce
        monkeypatch.setattr(bi, "bi_reduce", lambda x, mode=SUM: (
            kbr.bi_logsumexp_chain_ref(x) if mode == LOGSUMEXP
            else real(x, mode)))
    logits, labels, q, k, v, g = _infinite_max_inputs()
    if op == "nll":
        def loss(z):
            lse_ = jax.scipy.special.logsumexp(z, axis=-1)
            return lse_ - jnp.take_along_axis(z, jnp.asarray(labels)[:, None],
                                              -1)[:, 0]
        want, vjp = jax.vjp(loss, jnp.asarray(logits))
        (dwant,) = vjp(jnp.ones(5, jnp.float32))
        x = torch.from_numpy(logits).requires_grad_(True)
        with forced():
            got = bi.nll(x, torch.from_numpy(labels))
            got.sum().backward()
        _nan_and_close(got.detach().numpy(), np.asarray(want), "nll")
        _nan_and_close(x.grad.numpy(), np.asarray(dwant), "dlogits")
        assert np.isinf(got[1].item()) and np.isnan(got[2].item())
        return
    ref = reference("kernels.ref")
    scale = 8 ** -0.5
    _, vjp = jax.vjp(lambda a, b, c: ref.flash_attention_ref(
        a, b, c, causal=False, scale=scale),
        *(jnp.asarray(t) for t in (q, k, v)))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    with forced():
        got = [t.numpy() for t in bi.invariant_vjp(
            *(torch.from_numpy(t) for t in (q, k, v, g)), False, None,
            scale)]
    for name, a, b in zip(("dq", "dk"), got, want):
        _nan_and_close(a, b, name)
    dv, dv_jax = got[2], want[2]
    assert np.isnan(dv_jax).all() and np.isnan(dv).sum() == 64 == dv.size


@pytest.mark.parametrize("stacked", [True, False])
def test_the_embedding_gradient_is_a_one_hot_product(stacked, forced):
    table = _rand(3, 64, 16) if stacked else _rand(64, 16)
    tok = torch.as_tensor(np.random.default_rng(8).integers(0, 64, (3, 4, 9)))
    g = _rand(3, 4, 9, 16, seed=9)
    t = table.clone().requires_grad_(True)
    with forced():
        out = transformer._embed(t, tok)
    with _Ops() as ops:
        (got,) = torch.autograd.grad(out, [t], g)
    assert ops["repro_torch.bi_gemm"] == 1, ops
    assert not ops.keys() & bi.TORCH_SUMS, ops
    t2 = table.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(transformer._embed(t2, tok), [t2], g)
    assert torch.equal(out, transformer._embed(table, tok))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------- #
# 5. on the route no operator is a torch product or reduction
# ---------------------------------------------------------------------- #
class _Ops(TorchDispatchMode):
    """The operators run inside the block, counted by name."""

    def __enter__(self):
        self.ops = collections.Counter()
        super().__enter__()
        return self.ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _masked_losses(n):
    g = np.random.default_rng(10)
    x = torch.as_tensor(g.random((n, 50, 784), dtype=np.float32))
    y = torch.as_tensor(g.integers(0, 10, (n, 50)))
    tok = torch.as_tensor(g.integers(0, 64, (n, 8, 32)))
    m, mt = torch.ones(n, 50), torch.ones(n, 8)
    return {"mlp": (_mlp_params, lambda p: mlp.mlp_loss_masked(
                p, {"x": x, "y": y, "m": m}), 0.1),
            "lm": (_lm_params, lambda p: transformer.lm_loss_masked(
                LM_TINY, p, {"tokens": tok, "m": mt}), 0.3)}


@pytest.mark.parametrize("model", ["mlp", "lm"])
def test_a_routed_step_runs_no_torch_product_or_reduction(model, forced):
    """The stacked masked step and the loop oracle's unstacked step, each
    on the route: every product and sum is one of the two kernels'
    operators (forward and backward)."""
    init, loss, lr = _masked_losses(3)[model]
    params = init()
    tok = torch.as_tensor(np.random.default_rng(11).integers(0, 64, (8, 32)))
    x, y = _rand(50, 784).abs(), torch.arange(50) % 10
    one = ((lambda p: mlp.mlp_loss(p, {"x": x, "y": y})) if model == "mlp"
           else (lambda p: transformer.lm_loss(LM_TINY, p,
                                               {"tokens": tok})))
    for fn, p in ((loss, _stack(params, 3)), (one, params)):
        with forced(), _Ops() as ops:
            sgd_step(p, fn, lr)
        assert not ops.keys() & bi.TORCH_SUMS, ops.keys() & bi.TORCH_SUMS
        assert ops["repro_torch.bi_gemm"] and ops["repro_torch.bi_reduce"]


@pytest.mark.parametrize("task", [MnistTask(), LmTask()],
                         ids=["mlp", "lm"])
def test_a_routed_evaluation_runs_no_torch_product_or_reduction(task,
                                                                forced):
    """The task plane's evaluations (its methods and ``cohort_eval``, which
    enter the route themselves): the kernels' operators only."""
    n = 3
    if isinstance(task, MnistTask):
        params, ei = _mlp_params(), {"x": _rand(40, 784).abs()}
        d = {"x": _rand(n, 50, 784).abs(),
             "y": torch.arange(150).reshape(n, 50) % 10}
        units, m = 40, torch.ones(n, 50)
    else:
        g = np.random.default_rng(12)
        params = _lm_params()
        ei = {"tokens": torch.as_tensor(g.integers(0, 64, (5, 32)))}
        d = {"tokens": torch.as_tensor(g.integers(0, 64, (n, 8, 32)))}
        units, m = 5 * 31, torch.ones(n, 8)
    stacked = _stack(params, n)
    y = torch.arange(units) % 10
    with forced(), torch.no_grad(), _Ops() as ops:
        task.local_metric(stacked, d, m)
        cohort.cohort_eval(task, stacked, ei, y, torch.ones(n, units))
        if isinstance(task, LmTask):
            task.eval_loss(params, ei)
    assert not ops.keys() & bi.TORCH_SUMS, ops.keys() & bi.TORCH_SUMS
    assert ops["repro_torch.bi_gemm"] and ops["repro_torch.bi_reduce"]


@pytest.mark.parametrize("model", ["mlp", "lm"])
def test_a_backward_on_another_thread_stays_on_the_route(model, forced):
    """The route is chosen at the forward: a backward run by another
    thread, outside ``route()`` (as CUDA's autograd runs a backward on its
    device thread), still launches only the kernels, K3's gradient
    included, and gives the same gradients bit for bit."""
    init, loss, _ = _masked_losses(3)[model]
    params = _stack(init(), 3)

    def graph():
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with forced():
            out = loss(p)
        return out, list(p.values())
    out, leaves = graph()
    got, ops = [], collections.Counter()

    def backward():
        with _Ops() as seen:
            got.extend(torch.autograd.grad(out, leaves,
                                           torch.ones_like(out)))
        ops.update(seen)
    worker = threading.Thread(target=backward)
    worker.start()
    worker.join()
    assert not bi._active()
    assert not ops.keys() & bi.TORCH_SUMS, ops.keys() & bi.TORCH_SUMS
    assert ops["repro_torch.bi_gemm"]
    out, leaves = graph()
    want = torch.autograd.grad(out, leaves, torch.ones_like(out))
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_broadcast_sums_must_be_one_run():
    assert bi._sum_rmd((64,), (8, 32, 64)) == (1, 256, 64)
    assert bi._sum_rmd((3, 1, 1, 64), (3, 8, 32, 64)) == (3, 256, 64)
    assert bi._sum_rmd((8, 32, 1), (8, 32, 64)) == (256, 64, 1)
    assert bi._sum_rmd((8, 1, 64), (8, 1, 64)) == (512, 1, 1)
    with pytest.raises(ValueError, match="one run"):
        bi._sum_rmd((1, 5, 1), (4, 5, 6))


def test_the_contract_checker_finds_both_twins():
    from pathlib import Path

    from repro_torch.check.common import make_context
    from repro_torch.check.registry import check_kernel_twins
    ctx = make_context(Path(__file__).resolve().parents[1])
    assert [v for v in check_kernel_twins(ctx)
            if "bi_" in v.format()] == []
