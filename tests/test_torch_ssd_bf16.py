"""K6's bf16 compute (``ssm.compute_dtype="bfloat16"``, the hillclimb's
``ssd_bf16`` variant): the port's ``ssd_chunked(compute_dtype=bf16)`` and
``ssm_apply`` under a bf16-compute config against the reference's; the
wrapper's CPU route (the chunked form) and its gradient; R7 under bf16
compute (the reference's gradient NaN, the port's finite); the
tensor-core route's numerics at bf16 compute emulated in float32 against
the plain version to the card's tolerance; the route and the config's
checks. The CUDA route runs only on the card (``chip_smoke.py`` phase
17).

Tolerances: 1e-2·max|y| for bf16 compute against the reference (both
round the decay matrix, the scores and x·dt to bf16 in the same places;
the sums' order differs, and a bf16 product rounds differently after
that), 1e-5 relative where the float32 path is compared with itself; the
emulated kernel route within 2e-2·max|y| of the plain version (the
card's check in phase 17).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.configs import registry
from repro_torch.configs.base import SSMConfig
from repro_torch.convert import flatten_tree, params_from_numpy
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.models import ssm as tssm

SHAPES = [  # B, L, H, P, N, G, chunk
    (2, 256, 4, 32, 16, 4, 64),
    (1, 128, 2, 64, 32, 1, 128),
    (2, 96, 4, 16, 8, 2, 32),
]
BF16_TOL = 1e-2


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    return types.SimpleNamespace(ssm=reference("models.ssm"),
                                 reg=reference("configs.registry"),
                                 jax=jax, jnp=jnp)


def _inputs(B, L, H, P, N, G, seed=0, dt_shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)) + dt_shift)).astype(
        np.float32)
    A = (-np.exp(0.2 * rng.standard_normal(H))).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,P,N,G,chunk", SHAPES)
def test_ssd_chunked_bf16_matches_reference(ref, B, L, H, P, N, G, chunk,
                                            x_dtype):
    """y and the final state of the port's bf16-compute chunked SSD
    against the reference's, with and without an initial state, x in
    float32 or bf16 (B and C in x's dtype)."""
    x, dt, A, Bm, Cm = _inputs(B, L, H, P, N, G, seed=3)
    rep = H // G
    bh, ch = np.repeat(Bm, rep, 2), np.repeat(Cm, rep, 2)
    s0 = np.random.default_rng(4).standard_normal(
        (B, H, N, P)).astype(np.float32)
    jd, td = getattr(ref.jnp, x_dtype), getattr(torch, x_dtype)
    for init in (None, s0):
        want_y, want_s = ref.ssm.ssd_chunked(
            ref.jnp.asarray(x).astype(jd), ref.jnp.asarray(dt),
            ref.jnp.asarray(A), ref.jnp.asarray(bh).astype(jd),
            ref.jnp.asarray(ch).astype(jd), chunk,
            initial_state=None if init is None else ref.jnp.asarray(init),
            compute_dtype=ref.jnp.bfloat16)
        y, s = tssm.ssd_chunked(
            torch.from_numpy(x).to(td), torch.from_numpy(dt),
            torch.from_numpy(A), torch.from_numpy(bh).to(td),
            torch.from_numpy(ch).to(td), chunk,
            initial_state=None if init is None else torch.from_numpy(init),
            compute_dtype=torch.bfloat16)
        assert y.dtype == td and s.dtype == torch.float32
        assert _rel(y.float(), want_y.astype(np.float32)) <= BF16_TOL
        assert _rel(s, want_s) <= BF16_TOL


def test_float32_compute_is_the_unchanged_chunked_form():
    """compute_dtype float32 (the default) is the same bits as before the
    option existed: every product in float32."""
    x, dt, A, Bm, Cm = map(torch.from_numpy, _inputs(1, 128, 2, 16, 8, 2))
    bh, ch = Bm.repeat_interleave(1, 2), Cm.repeat_interleave(1, 2)
    y, s = kssd.ssd_chunked(x, dt, A, bh, ch, 32)
    y2, s2 = kssd.ssd_chunked(x, dt, A, bh, ch, 32,
                              compute_dtype="float32")
    assert torch.equal(y, y2) and torch.equal(s, s2)
    y3, _ = kssd.ssd_chunked(x, dt, A, bh, ch, 32, compute_dtype="bfloat16")
    assert not torch.equal(y, y3)


def _mamba(ref, compute_dtype):
    """Reduced mamba2 (float32 weights) in both packages at
    ``compute_dtype``, and one SSM layer's weights, the reference's drawn
    and carried across."""
    cfg_ref = dataclasses.replace(ref.reg.reduced(ref.reg.get("mamba2-370m")),
                                  dtype="float32")
    cfg_ref = dataclasses.replace(cfg_ref, ssm=dataclasses.replace(
        cfg_ref.ssm, compute_dtype=compute_dtype))
    cfg = dataclasses.replace(registry.reduced(registry.get("mamba2-370m")),
                              dtype="float32")
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, compute_dtype=compute_dtype))
    p_ref = ref.ssm.ssm_init(ref.jax.random.PRNGKey(0), cfg_ref)
    p_np = ref.jax.tree.map(np.asarray, p_ref)
    return cfg_ref, cfg, p_ref, params_from_numpy(flatten_tree(p_np), "cpu")


def test_ssm_apply_bf16_compute_matches_reference(ref):
    """The SSM block under a bf16-compute config, the same weights: its
    output and SSM state against the reference's, and apart from the
    float32-compute block's (the option reaches the scan)."""
    cfg_ref, cfg, p_ref, p = _mamba(ref, "bfloat16")
    x = (0.5 * np.random.default_rng(7).standard_normal(
        (2, 64, cfg.d_model))).astype(np.float32)
    y_ref, (_, st_ref) = ref.ssm.ssm_apply(cfg_ref, p_ref,
                                           ref.jnp.asarray(x))
    y, (_, st) = tssm.ssm_apply(cfg, p, torch.from_numpy(x))
    assert _rel(y.numpy(), y_ref) <= BF16_TOL
    assert _rel(st.numpy(), st_ref) <= BF16_TOL
    _, cfg32, _, _ = _mamba(ref, "float32")
    y32, _ = tssm.ssm_apply(cfg32, p, torch.from_numpy(x))
    assert not torch.equal(y, y32)


def test_cpu_route_is_the_chunked_form_and_launches_nothing():
    """On CPU tensors ``ssd_scan(compute_dtype="bfloat16")`` is the plain
    ``ssd_chunked`` at bf16 compute (grouped B/C repeated to the heads),
    bit for bit; float32 compute stays the sequential recurrence."""
    x, dt, A, Bm, Cm = map(torch.from_numpy, _inputs(2, 128, 4, 16, 8, 2))
    x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    before = kssd.ssd_scan.launches
    y, s = kssd.ssd_scan(x, dt, A, Bm, Cm, chunk=64,
                         compute_dtype="bfloat16")
    want_y, want_s = kssd.ssd_chunked(x, dt, A, Bm.repeat_interleave(2, 2),
                                      Cm.repeat_interleave(2, 2), 64,
                                      compute_dtype=torch.bfloat16)
    assert torch.equal(y, want_y) and torch.equal(s, want_s)
    y32, s32 = kssd.ssd_scan(x, dt, A, Bm, Cm, chunk=64)
    ref_y, ref_s = kssd.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=64)
    assert torch.equal(y32, ref_y) and torch.equal(s32, ref_s)
    assert kssd.ssd_scan.launches == before


def test_bf16_gradient_is_the_chunked_vjp_and_finite():
    """Every input's gradient through the Function at bf16 compute equals
    autograd through the plain bf16 chunked form, and is finite."""
    arrays = _inputs(1, 64, 2, 16, 8, 1, seed=5)
    got, want = [], []
    for fn, out in ((lambda *t: kssd.ssd_scan(*t, chunk=32,
                                              compute_dtype="bfloat16"), got),
                    (lambda x, dt, A, B_, C_: kssd.ssd_chunked(
                        x, dt, A, B_.repeat_interleave(2, 2),
                        C_.repeat_interleave(2, 2), 32,
                        compute_dtype=torch.bfloat16), want)):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        y, _ = fn(*ts)
        out.extend(torch.autograd.grad(y.square().sum(), ts))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_r7_under_bf16_compute(ref):
    """R7 at bf16 compute: past an e^88 decay over a chunk the reference's
    ``where(causal, exp(seg), 0)`` overflows above the diagonal and its
    dt gradient is NaN; the port masks before the exponent and every
    gradient through K6's Function is finite."""
    x, dt, A, Bm, Cm = _inputs(1, 512, 4, 16, 16, 1, seed=9)
    dt = dt + 0.5                             # a chunk's decay ~ e^-300
    jax, jnp = ref.jax, ref.jnp
    _, vjp = jax.vjp(
        lambda *a: ref.ssm.ssd_chunked(*a, 256,
                                       compute_dtype=jnp.bfloat16)[0],
        *map(jnp.asarray, (x, dt, A, np.repeat(Bm, 4, 2),
                           np.repeat(Cm, 4, 2))))
    assert not np.isfinite(np.asarray(vjp(jnp.ones(x.shape))[1])).all()
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in (x, dt, A, Bm, Cm)]
    y, _ = kssd.ssd_scan(*ts, chunk=256, compute_dtype="bfloat16")
    for g in torch.autograd.grad(y.sum(), ts):
        assert bool(torch.isfinite(g).all())


# --- the tensor-core route at bf16 compute, emulated in float32 ------------

def _bf16(t):
    return t.to(torch.bfloat16).float()


def _emulation(x, dt, A, Bm, Cm, chunk):
    """``csrc/ssd_scan.cu``'s three stages with the template flag kSplit
    off, in float32 torch: x, B and C enter as they are (bf16 values); the
    decayed x rows of the chunk states, the state entering each chunk and
    the decayed, masked score matrix each rounded to bf16 once before its
    product; every sum float32, the carried state float32."""
    b, length, h, p = x.shape
    g, n = Bm.shape[2:]
    nc, rep = length // chunk, h // g
    r = lambda t: t.reshape(b, nc, chunk, *t.shape[2:])
    xc, dtc = r(x), r(dt)
    bc, cc = r(Bm.repeat_interleave(rep, 2)), r(Cm.repeat_interleave(rep, 2))
    cum = torch.cumsum(dtc * A, dim=2)
    w = torch.exp(cum[:, :, -1:] - cum) * dtc
    s_local = torch.einsum("bcqhn,bcqhp->bchnp", bc,
                           _bf16(xc * w[..., None]))
    state, entering = torch.zeros(b, h, n, p), []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(cum[:, c, -1])[..., None, None] \
            + s_local[:, c]
    inter = torch.einsum("bchnp,bcihn->bcihp",
                         _bf16(torch.stack(entering, 1)), cc)
    scores = torch.einsum("bcihn,bcjhn->bchij", cc, bc)
    chh = cum.permute(0, 1, 3, 2)
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    seg = torch.where(tril, chh[..., :, None] - chh[..., None, :], 0.0)
    m = torch.where(tril, scores * torch.exp(seg)
                    * dtc.permute(0, 1, 3, 2)[..., None, :], 0.0)
    y = torch.einsum("bchij,bcjhp->bcihp", _bf16(m), xc) \
        + torch.exp(cum)[..., None] * inter
    return _bf16(y.reshape(b, length, h, p)), state


@pytest.mark.parametrize("B,L,H,P,N,G,chunk", [
    (1, 512, 4, 64, 128, 1, 256),      # mamba2's head, state and chunk
    (1, 256, 8, 32, 64, 2, 64),        # grouped B/C, Q 64
])
def test_bf16_compute_route_emulation_holds_the_plain_version(
        B, L, H, P, N, G, chunk):
    """The bf16-compute route's numerics hold its plain version (the
    bf16-compute chunked form) within phase 17's 2e-2·max|y| and
    2e-2·max|state|, before any time on the card."""
    x, dt, A, Bm, Cm = map(torch.from_numpy, _inputs(B, L, H, P, N, G,
                                                     seed=11))
    x, Bm, Cm = _bf16(x), _bf16(Bm), _bf16(Cm)
    y, state = _emulation(x, dt, A, Bm, Cm, chunk)
    rep = H // G
    want_y, want_s = kssd.ssd_chunked(
        x.to(torch.bfloat16), dt, A,
        Bm.to(torch.bfloat16).repeat_interleave(rep, 2),
        Cm.to(torch.bfloat16).repeat_interleave(rep, 2), chunk,
        compute_dtype=torch.bfloat16)
    assert _rel(y, want_y.float()) <= 2e-2
    assert _rel(state, want_s) <= 2e-2


# --- the route and the config -----------------------------------------------

def test_bf16_compute_takes_the_tensor_core_route_or_raises():
    """bf16 compute has one route, the tensor cores' at the shapes they
    take; a call they cannot take raises instead of computing in float32
    unasked (float32 x, N 8, a chunk of 32, misaligned inputs)."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert kssd.route(bf16, 64, 128, 256, compute_dtype=bf16) \
        == "tensor_cores_bf16"
    assert kssd.route(bf16, 64, 128, 256) == "tensor_cores"
    for args in ((f32, 64, 128, 256), (bf16, 64, 8, 256),
                 (bf16, 64, 128, 32), (bf16, 48, 128, 256)):
        with pytest.raises(ValueError, match="bf16 compute"):
            kssd.route(*args, compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="bf16 compute"):
        kssd.route(bf16, 64, 128, 256, aligned=False, compute_dtype=bf16)


def test_kernel_refuses_float32_inputs_at_bf16_compute_before_any_launch():
    """The launch itself refuses float32 x with bf16 compute before the
    kernel is built or launched (so CPU tensors reach the refusal)."""
    x, dt, A, Bm, Cm = map(torch.from_numpy, _inputs(1, 256, 2, 64, 128, 1))
    before = kssd.ssd_scan.launches
    with pytest.raises(ValueError, match="bf16 compute"):
        kssd._kernel(x, dt, A, Bm, Cm, 256, None, torch.bfloat16)
    assert kssd.ssd_scan.launches == before


@pytest.mark.parametrize("value,ok", [
    ("float32", True), ("bfloat16", True), ("float16", False),
    ("bf16", False), ("float64", False), (torch.bfloat16, False)])
def test_config_takes_float32_or_bfloat16_only(value, ok):
    if ok:
        assert SSMConfig(compute_dtype=value).compute_dtype == value
        cfg = registry.get("mamba2-370m")
        assert dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, compute_dtype=value)).ssm.compute_dtype == value
    else:
        with pytest.raises(ValueError, match="compute_dtype"):
            SSMConfig(compute_dtype=value)


def test_compute_dtype_of():
    assert kssd.compute_dtype_of("bfloat16") is torch.bfloat16
    assert kssd.compute_dtype_of(torch.float32) is torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        kssd.compute_dtype_of("float16")
