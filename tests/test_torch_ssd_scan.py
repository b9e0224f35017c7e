"""Port parity of the Mamba2 SSD scan kernel K6 (``ssd_scan``) and the SSM
block around it: the plain PyTorch version — the sequential recurrence the
wrapper runs on CPU tensors — against the Pallas TPU kernel (interpret
mode, through the JAX package's ``ops.ssd_scan``) and
``repro.kernels.ref.ssd_ref`` (y and the final state); the port's
``ssd_chunked`` against the reference's; ``ssm_apply`` and
``ssm_decode`` against the reference's on the same weights. The CUDA
kernel runs only on the card; ``chip_smoke.py`` holds it against the plain
version there.

Tolerances: 5e-4 absolute and relative for the scan against the Pallas
kernel and the oracle (tests/test_kernels.py's: the chunked and the
sequential forms sum in other orders); 1e-5 relative where both sides run
the same algorithm in float32 (``ssd_chunked``, the SSM block), with 1e-4
absolute beside it for ``ssd_chunked``, whose einsums sum up to Q terms of
magnitude up to ~60 in another order (float32: ~1e-4 near a zero).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.configs import registry
from repro_torch.convert import flatten_tree, params_from_numpy
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
from repro_torch.models import ssm as tssm
from repro_torch.random import PRNGKey

SHAPES = [  # B, L, H, P, N, G, chunk: tests/test_kernels.py's
    (2, 256, 4, 32, 16, 4, 64),
    (1, 128, 2, 64, 32, 1, 128),   # grouped B/C
    (1, 64, 8, 16, 8, 8, 16),
]
TOL = dict(atol=5e-4, rtol=5e-4)
EXACT = dict(atol=1e-5, rtol=1e-5)
CHUNKED = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    return types.SimpleNamespace(ops=reference("kernels.ops"),
                                 kref=reference("kernels.ref"),
                                 ssm=reference("models.ssm"),
                                 reg=reference("configs.registry"),
                                 jax=jax, jnp=jnp)


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")


def _inputs(B, L, H, P, N, G, seed=0):
    """x, dt (softplus of a normal), A (-exp of a small normal), B, C."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = (-np.exp(0.2 * rng.standard_normal(H))).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.mark.parametrize("B,L,H,P,N,G,chunk", SHAPES)
def test_plain_matches_pallas_and_ref(ref, B, L, H, P, N, G, chunk):
    arrays = _inputs(B, L, H, P, N, G)
    j = [ref.jnp.asarray(a) for a in arrays]
    pallas = ref.ops.ssd_scan(*j, chunk=chunk)
    rep = H // G
    y_ref, s_ref = ref.kref.ssd_ref(j[0], j[1], j[2],
                                    ref.jnp.repeat(j[3], rep, 2),
                                    ref.jnp.repeat(j[4], rep, 2))
    t = [torch.from_numpy(a) for a in arrays]
    before = ssd_scan.launches
    for y, state in (ssd_scan(*t, chunk=chunk),
                     ssd_scan_ref(*t, chunk=chunk)):
        assert y.shape == (B, L, H, P) and y.dtype == torch.float32
        assert state.shape == (B, H, N, P) and state.dtype == torch.float32
        _close(y.numpy(), pallas, TOL)
        _close(y.numpy(), y_ref, TOL)
        _close(state.numpy(), s_ref, TOL)
    assert ssd_scan.launches == before      # the CPU route


def test_bfloat16_inputs_give_bfloat16_y():
    """x, B and C in bfloat16: y comes back in x's dtype, the state in
    float32, both from float32 arithmetic on the rounded inputs."""
    x, dt, A, Bm, Cm = map(torch.from_numpy, _inputs(1, 32, 2, 16, 8, 1))
    xb, bb, cb = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    y, state = ssd_scan(xb, dt, A, bb, cb, chunk=16)
    y32, s32 = ssd_scan_ref(xb.float(), dt, A, bb.float(), cb.float(),
                            chunk=16)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert torch.equal(y, y32.to(torch.bfloat16))
    assert torch.equal(state, s32)


@pytest.mark.parametrize("B,L,H,P,N,G,chunk", SHAPES + [
    (2, 96, 4, 16, 8, 2, 32)])
def test_ssd_chunked_matches_reference(ref, B, L, H, P, N, G, chunk):
    """The port's chunked SSD against the reference's (per-head B/C), with
    and without an initial state; and against the plain scan."""
    x, dt, A, Bm, Cm = _inputs(B, L, H, P, N, G, seed=1)
    rep = H // G
    bh, ch = np.repeat(Bm, rep, 2), np.repeat(Cm, rep, 2)
    s0 = np.random.default_rng(2).standard_normal(
        (B, H, N, P)).astype(np.float32)
    for init in (None, s0):
        want_y, want_s = ref.ssm.ssd_chunked(
            *map(ref.jnp.asarray, (x, dt, A, bh, ch)), chunk,
            initial_state=None if init is None else ref.jnp.asarray(init))
        tinit = None if init is None else torch.from_numpy(init)
        y, s = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, bh, ch)),
                                chunk, initial_state=tinit)
        _close(y.numpy(), want_y, CHUNKED)
        _close(s.numpy(), want_s, CHUNKED)
        y2, s2 = ssd_scan(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                          chunk=chunk, initial_state=tinit)
        _close(y2.numpy(), want_y, TOL)
        _close(s2.numpy(), want_s, TOL)


def test_length_not_a_multiple_of_the_chunk_raises():
    t = list(map(torch.from_numpy, _inputs(1, 48, 2, 16, 8, 1)))
    for fn in (ssd_scan, ssd_scan_ref):
        with pytest.raises(ValueError, match="multiple of the chunk"):
            fn(*t, chunk=32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssm.ssd_chunked(*t[:3], t[3], t[4], 32)
    y, _ = ssd_scan(*t, chunk=64)           # Q = min(chunk, L) = 48
    assert y.shape == (1, 48, 2, 16)


def test_rejects_mismatched_inputs():
    x, dt, A, Bm, Cm = map(torch.from_numpy, _inputs(1, 16, 6, 16, 8, 4))
    with pytest.raises(ValueError, match="multiple"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=16)      # 6 heads over 4 groups
    x, dt, A, Bm, Cm = map(torch.from_numpy, _inputs(1, 16, 4, 16, 8, 2))
    with pytest.raises(TypeError):
        ssd_scan(x, dt.double(), A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="initial_state"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=16,
                 initial_state=torch.zeros(1, 4, 8, 8))


@pytest.mark.parametrize("which", ["x", "dt", "A", "B", "C", "state"])
def test_kernel_route_refuses_grad_before_any_launch(which):
    """A launch of the kernel alone is forward-only: with grad mode on, an
    input that requires grad raises NotImplementedError before the kernel
    is built or launched (so CPU tensors reach the guard); ``ssd_scan``'s
    autograd Function, which calls it with grad mode off, carries the
    gradient."""
    t = dict(zip(("x", "dt", "A", "B", "C"),
                 map(torch.from_numpy, _inputs(1, 32, 4, 16, 8, 2))))
    t["state"] = torch.zeros(1, 4, 8, 16)
    t[which] = t[which].clone().requires_grad_(True)
    args = (t["x"], t["dt"], t["A"], t["B"], t["C"])
    before = ssd_scan.launches
    with pytest.raises(NotImplementedError, match="forward-only"):
        kssd._kernel(*args, 16, t["state"])
    assert ssd_scan.launches == before
    y, state = ssd_scan(*args, chunk=16, initial_state=t["state"])
    (y.sum() + state.sum()).backward()
    assert t[which].grad is not None
    assert bool(torch.isfinite(t[which].grad).all())


def _mamba(ref):
    """The reduced mamba2 config of both packages (float32) and one SSM
    layer's weights, the reference's drawn and carried across."""
    cfg_ref = dataclasses.replace(ref.reg.reduced(ref.reg.get("mamba2-370m")),
                                  dtype="float32")
    cfg = dataclasses.replace(registry.reduced(registry.get("mamba2-370m")),
                              dtype="float32")
    p_ref = ref.ssm.ssm_init(ref.jax.random.PRNGKey(0), cfg_ref)
    p_np = ref.jax.tree.map(np.asarray, p_ref)
    return cfg_ref, cfg, p_ref, params_from_numpy(flatten_tree(p_np), "cpu")


def test_ssm_init_dt_bias_and_layout_match_reference(ref):
    cfg_ref, cfg, p_ref, _ = _mamba(ref)
    got = tssm.ssm_init(PRNGKey(0, "cpu"), cfg)
    want = ref.jax.tree.map(np.asarray, p_ref)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
    for k in ("dt_bias", "A_log", "D", "conv_b", "norm"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_ssm_apply_and_decode_match_reference(ref):
    """The SSM block on the same weights: prefill (the SSD through K6's
    plain version) returns the reference's output, conv state and SSM
    state; then single-token decodes continue it as the reference's."""
    cfg_ref, cfg, p_ref, p = _mamba(ref)
    rng = np.random.default_rng(7)
    x = (0.5 * rng.standard_normal((2, 40, cfg.d_model))).astype(np.float32)
    y_ref, (conv_ref, st_ref) = ref.ssm.ssm_apply(
        cfg_ref, p_ref, ref.jnp.asarray(x[:, :32]))
    y, (conv, st) = tssm.ssm_apply(cfg, p, torch.from_numpy(x[:, :32]))
    _close(y.numpy(), y_ref, EXACT)
    _close(conv.numpy(), conv_ref, EXACT)
    _close(st.numpy(), st_ref, EXACT)
    for t in range(32, 40):
        y_ref, conv_ref, st_ref = ref.ssm.ssm_decode(
            cfg_ref, p_ref, ref.jnp.asarray(x[:, t:t + 1]), conv_ref, st_ref)
        y, conv, st = tssm.ssm_decode(cfg, p, torch.from_numpy(x[:, t:t + 1]),
                                      conv, st)
        _close(y.numpy(), y_ref, EXACT)
        _close(st.numpy(), st_ref, EXACT)
    _close(conv.numpy(), conv_ref, EXACT)


# --- the tensor-core route's numerics (three stages, float32 operands split
# into bf16 hi/lo pairs) and the route function ------------------------------

def _bf16(t):
    return t.to(torch.bfloat16).float()


def _hi_lo(t):
    """hi = bf16(t), lo = bf16(t - hi): the kernel's operand pair."""
    hi = _bf16(t)
    return hi, _bf16(t - hi)


def _rounded_once(t):
    """One bf16 rounding, the pair's lo left out."""
    return _bf16(t), torch.zeros_like(t)


def _chunked_emulation(x, dt, A, Bm, Cm, chunk, initial_state=None,
                       operands=_hi_lo):
    """The tensor-core route of ``csrc/ssd_scan.cu`` in float32 torch: (1)
    the chunks' local states (B ∘ exp(cum_Q − cum)·dt)ᵀ x, (2) the state
    passing, keeping the state that enters each chunk, (3) the chunk scan
    diag(exp(cum))·C·S + (C·Bᵀ ∘ tril(exp(cum_i − cum_j)) ∘ dt_j)·x. x, B
    and C hold bf16 values and enter the products as they are; every
    float32 operand (the decayed B rows, the entering state, the masked
    score matrix) enters as ``operands(v)``, a pair whose two products are
    summed in float32, as the kernel's two mma are. Returns y rounded to
    bf16 and the final state."""
    b, length, h, p = x.shape
    g, n = Bm.shape[2:]
    q = min(chunk, length)
    nc, rep = length // q, h // g
    r = lambda t: t.reshape(b, nc, q, *t.shape[2:])
    xc, dtc = r(x), r(dt)
    bc, cc = r(Bm.repeat_interleave(rep, 2)), r(Cm.repeat_interleave(rep, 2))
    cum = torch.cumsum(dtc * A, dim=2)                           # (b,nc,q,h)
    pair = lambda eq, a, u: sum(torch.einsum(eq, o, u) for o in operands(a))
    # 1. chunk states
    w = torch.exp(cum[:, :, -1:] - cum) * dtc
    s_local = pair("bcqhn,bcqhp->bchnp", bc * w[..., None], xc)
    # 2. state passing
    state = (torch.zeros(b, h, n, p) if initial_state is None
             else initial_state)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(cum[:, c, -1])[..., None, None] \
            + s_local[:, c]
    # 3. chunk scan
    inter = pair("bchnp,bcihn->bcihp", torch.stack(entering, 1), cc)
    scores = torch.einsum("bcihn,bcjhn->bchij", cc, bc)
    ch = cum.permute(0, 1, 3, 2)                                 # (b,nc,h,q)
    tril = torch.tril(torch.ones(q, q, dtype=torch.bool))
    seg = torch.where(tril, ch[..., :, None] - ch[..., None, :], 0.0)
    m = torch.where(tril, scores * torch.exp(seg)
                    * dtc.permute(0, 1, 3, 2)[..., None, :], 0.0)
    y = pair("bchij,bcjhp->bcihp", m, xc) + torch.exp(cum)[..., None] * inter
    return _bf16(y.reshape(b, length, h, p)), state


def _bf16_inputs(B, L, H, P, N, G, seed):
    """check_ssd's draw: x, B and C rounded to bf16 (held as float32)."""
    x, dt, A, Bm, Cm = map(torch.from_numpy,
                           _inputs(B, L, H, P, N, G, seed=seed))
    return _bf16(x), dt, A, _bf16(Bm), _bf16(Cm)


def _state_holds(got, want):
    return bool(((got - want).abs() <= 5e-4 + 5e-4 * want.abs()).all())


def _y_holds(got, want):
    return bool(((got - want).abs() <= 2e-2 + 2e-2 * want.abs()).all())


@pytest.mark.parametrize("B,L,H,P,N,G,chunk,init", [
    (1, 512, 4, 64, 128, 1, 256, False),   # mamba2's head, state and chunk
    (1, 512, 4, 64, 128, 1, 256, True),
    (1, 256, 8, 32, 64, 2, 64, True),      # grouped B/C, Q 64
])
def test_split_bf16_chunked_matches_ref_and_pallas(ref, B, L, H, P, N, G,
                                                   chunk, init):
    """The three stages with every float32 operand split hi/lo hold the
    plain sequential scan (and the Pallas kernel in interpret mode) to the
    card's tolerances: the final state within 5e-4 + 5e-4·|plain|, y (bf16)
    within 2e-2 + 2e-2·|plain|."""
    x, dt, A, Bm, Cm = _bf16_inputs(B, L, H, P, N, G, seed=11)
    s0 = (torch.from_numpy(np.random.default_rng(12).standard_normal(
        (B, H, N, P)).astype(np.float32)) if init else None)
    y, state = _chunked_emulation(x, dt, A, Bm, Cm, chunk, s0)
    y_ref, s_ref = ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                                initial_state=s0)
    assert _state_holds(state, s_ref)
    assert _y_holds(y, _bf16(y_ref))
    if not init:      # the Pallas kernel starts from a zero state
        pallas = ref.ops.ssd_scan(*(ref.jnp.asarray(t.numpy())
                                    for t in (x, dt, A, Bm, Cm)),
                                  chunk=chunk)
        assert _y_holds(y, _bf16(torch.from_numpy(np.array(pallas))))


def test_one_bf16_rounding_of_the_float32_operands_does_not_hold():
    """The same stages with each float32 operand rounded to bf16 once (no
    lo half) miss both checks at mamba2's head, state and chunk: the split
    is what holds them, before any time on the card."""
    x, dt, A, Bm, Cm = _bf16_inputs(1, 512, 4, 64, 128, 1, seed=11)
    y, state = _chunked_emulation(x, dt, A, Bm, Cm, 256,
                                  operands=_rounded_once)
    y_ref, s_ref = ssd_scan_ref(x, dt, A, Bm, Cm, chunk=256)
    assert not _state_holds(state, s_ref)
    assert not _y_holds(y, _bf16(y_ref))


def test_route_sends_the_zoo_to_the_tensor_cores():
    """Every SSM arch of the zoo at its serving dtype (bf16) takes the
    tensor-core route at its own P, N and chunk, also with L below the
    chunk when L is a multiple of 64."""
    ssm_archs = [registry.get(a) for a in registry.list_archs()
                 if registry.get(a).ssm is not None]
    assert {c.name for c in ssm_archs} >= {"mamba2-370m",
                                           "jamba-1.5-large-398b"}
    for cfg in ssm_archs:
        s = cfg.ssm
        for q in (s.chunk, 64):
            assert kssd.route(torch.bfloat16, s.head_dim, s.d_state,
                              q) == "tensor_cores", (cfg.name, q)


@pytest.mark.parametrize("dtype,p,n,q,aligned", [
    (torch.float32, 64, 128, 256, True),      # float32: the CUDA cores
    (torch.bfloat16, 64, 8, 256, True),       # N not a multiple of 16
    (torch.bfloat16, 64, 144, 256, True),     # N past the register tile
    (torch.bfloat16, 48, 128, 256, True),     # P not instantiated
    (torch.bfloat16, 64, 128, 96, True),      # Q not a multiple of 64
    (torch.bfloat16, 64, 128, 32, True),      # the reduced configs' chunk
    (torch.bfloat16, 64, 128, 256, False),    # not 16-byte aligned
])
def test_route_sends_other_shapes_to_the_cuda_cores(dtype, p, n, q,
                                                    aligned):
    assert kssd.route(dtype, p, n, q, aligned) == "cuda_cores"
