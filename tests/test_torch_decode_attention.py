"""Port parity of the flash-decode kernel K4 (``decode_attention``): its
plain PyTorch version — what the wrapper runs on CPU tensors — against the
Pallas TPU kernel (interpret mode, through the JAX package's
``ops.decode_attention``) and ``repro.kernels.ref.decode_attention_ref``;
its GQA grouping, the sliding-window view and the ring-buffer prefix that
``models/attention.attn_decode`` hands it, against the reference's masked
``sdpa`` and ``attn_decode``. The CUDA kernel runs only on the card;
``chip_smoke.py`` holds it against the plain version there.

Tolerances, those of tests/test_kernels.py: 2e-5 for float32 (another
summation order), 2e-2 for bfloat16 (the probabilities and the output
rounded to 8 mantissa bits), both absolute and relative.
"""
import types

import numpy as np
import pytest
import torch
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import flatten_tree, params_from_numpy
from repro_torch.kernels.decode_attention import (NEG_INF, TILE,
                                                  decode_attention,
                                                  decode_attention_ref,
                                                  splits)
from repro_torch.kernels import decode_attention as dattn
from repro_torch.models import attention as tatt

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SHAPES = [  # B, H, T, D, length: tests/test_kernels.py's
    (2, 4, 512, 64, 300),
    (1, 8, 1024, 128, 1024),
    (4, 2, 256, 64, 1),
]


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    return types.SimpleNamespace(ops=reference("kernels.ops"),
                                 kref=reference("kernels.ref"),
                                 att=reference("models.attention"),
                                 base=reference("configs.base"),
                                 jax=jax, jnp=jnp)


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    """The Pallas kernel runs in interpret mode (read at every call)."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")


def _inputs(B, H, Hkv, T, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, H, D), (B, T, Hkv, D), (B, T, Hkv, D))]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,D,length", SHAPES)
def test_plain_matches_pallas_and_ref(ref, B, H, T, D, length, dtype):
    arrays = _inputs(B, H, H, T, D)
    j = [ref.jnp.asarray(a).astype(getattr(ref.jnp, dtype)) for a in arrays]
    pallas = ref.ops.decode_attention(*j, length)
    oracle = ref.kref.decode_attention_ref(*j, length)
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    before = decode_attention.launches
    for got in (decode_attention(*t, length),
                decode_attention_ref(*t, length)):
        assert got.shape == (B, H, D) and got.dtype == t[0].dtype
        for want in (pallas, oracle):
            _close(got.float().numpy(), want, TOL[dtype])
    assert decode_attention.launches == before      # the CPU route


@pytest.mark.parametrize("B,H,Hkv,T,D,length", [
    (2, 12, 3, 96, 64, 70),     # G = 4
    (3, 8, 1, 40, 16, 40),      # one KV head (MQA)
    (1, 6, 2, 33, 32, 1),
])
def test_gqa_equals_ref_on_repeated_caches(ref, B, H, Hkv, T, D, length):
    """Query head h reads KV head h // (H/Hkv): the plain version on the
    grouped cache equals the reference's oracle on ``jnp.repeat``'s."""
    q, k, v = _inputs(B, H, Hkv, T, D, seed=1)
    g = H // Hkv
    want = ref.kref.decode_attention_ref(
        ref.jnp.asarray(q), ref.jnp.repeat(ref.jnp.asarray(k), g, axis=2),
        ref.jnp.repeat(ref.jnp.asarray(v), g, axis=2), length)
    got = decode_attention(*map(torch.from_numpy, (q, k, v)), length)
    _close(got.numpy(), want, TOL["float32"])


@pytest.mark.parametrize("index,window", [(40, 16), (9, 16), (63, 64),
                                          (20, None)])
def test_window_view_equals_masked_sdpa(ref, index, window):
    """A linear cache with a sliding window: the view [index - window + 1,
    index + 1) that attn_decode passes equals the reference's sdpa under
    attn_decode's mask (index - window < j <= index) over the whole
    cache."""
    B, H, Hkv, C, D = 2, 4, 2, 64, 32
    q, k, v = _inputs(B, H, Hkv, C, D, seed=2)
    j = np.arange(C)
    valid = j <= index
    if window is not None:
        valid &= j > index - window
    want = ref.att.sdpa(ref.jnp.asarray(q)[:, None], ref.jnp.asarray(k),
                        ref.jnp.asarray(v),
                        ref.jnp.asarray(valid)[None, None, None, None])
    hi = index + 1
    lo = max(0, hi - window) if window is not None else 0
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    got = decode_attention(torch.from_numpy(q), kt[:, lo:hi], vt[:, lo:hi],
                           hi - lo)
    _close(got.reshape(B, 1, H * D).numpy(), want, TOL["float32"])
    mask = torch.from_numpy(valid)[None, None, None, None]
    plain = tatt.sdpa(torch.from_numpy(q)[:, None], kt, vt, mask)
    _close(plain.numpy(), want, TOL["float32"])


def _attn_cfg(base, **kw):
    fields = dict(name="decode-test", family="dense", n_layers=1,
                  d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                  vocab_size=32, dtype="float32", qkv_bias=True,
                  rope_theta=10_000.0)
    fields.update(kw)
    return base(**fields)


def test_ring_prefix_equals_attn_decode(ref):
    """A ring cache filled by decode steps: its valid slots (slot_pos >= 0)
    are the prefix of min(index + 1, C) slots at every step, and the
    port's attn_decode (K4 over that prefix) gives the reference's output,
    caches and slot_pos step by step, through the wrap-around."""
    jnp = ref.jnp
    cfg_ref = _attn_cfg(ref.base.ModelConfig)
    cfg = _attn_cfg(ModelConfig)
    p_ref = ref.att.attn_init(ref.jax.random.PRNGKey(0), cfg_ref)
    p = params_from_numpy(flatten_tree(ref.jax.tree.map(np.asarray, p_ref)),
                          "cpu")
    B, C = 2, 8
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((20, B, 1, cfg.d_model)).astype(np.float32)
    shape = (B, C, cfg.n_kv_heads, cfg.head_dim)
    ck, cv = jnp.zeros(shape), jnp.zeros(shape)
    slot = jnp.full((C,), -1, jnp.int32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    tslot = torch.full((C,), -1, dtype=torch.int32)
    for index, x in enumerate(xs):
        y_ref, ck, cv, slot = ref.att.attn_decode(
            cfg_ref, p_ref, jnp.asarray(x), ck, cv, index, slot_pos=slot)
        y, tk, tv, tslot = tatt.attn_decode(cfg, p, torch.from_numpy(x), tk,
                                            tv, index, slot_pos=tslot)
        valid = np.asarray(slot) >= 0
        assert valid.tolist() == [s < min(index + 1, C) for s in range(C)]
        np.testing.assert_array_equal(tslot.numpy(), np.asarray(slot))
        _close(y.numpy(), y_ref, 1e-5)
        _close(tk.numpy(), ck, 1e-5)
        _close(tv.numpy(), cv, 1e-5)


def test_linear_window_attn_decode_matches_reference(ref):
    """attn_decode on a linear cache with a window (the view route) against
    the reference's, past the point where the window binds."""
    jnp = ref.jnp
    cfg_ref = _attn_cfg(ref.base.ModelConfig, qkv_bias=False, qk_norm=True)
    cfg = _attn_cfg(ModelConfig, qkv_bias=False, qk_norm=True)
    p_ref = ref.att.attn_init(ref.jax.random.PRNGKey(1), cfg_ref)
    p = params_from_numpy(flatten_tree(ref.jax.tree.map(np.asarray, p_ref)),
                          "cpu")
    B, C, W = 2, 24, 5
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((C, B, 1, cfg.d_model)).astype(np.float32)
    shape = (B, C, cfg.n_kv_heads, cfg.head_dim)
    ck, cv = jnp.zeros(shape), jnp.zeros(shape)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    for index, x in enumerate(xs):
        y_ref, ck, cv, _ = ref.att.attn_decode(
            cfg_ref, p_ref, jnp.asarray(x), ck, cv, index, window=W)
        y, tk, tv, _ = tatt.attn_decode(cfg, p, torch.from_numpy(x), tk, tv,
                                        index, window=W)
        _close(y.numpy(), y_ref, 1e-5)
    _close(tk.numpy(), ck, 1e-5)


@pytest.mark.parametrize("length", [0, -3, 65])
def test_length_outside_the_cache_raises(length):
    """length < 1 (ROADMAP P5: the TPU kernel would return the mean of V)
    and length > T raise on both routes."""
    q, k, v = map(torch.from_numpy, _inputs(1, 2, 2, 64, 16))
    for fn in (decode_attention, decode_attention_ref):
        with pytest.raises(ValueError, match="length"):
            fn(q, k, v, length)


@pytest.mark.parametrize("blocks,length", [
    (32, 2048), (32, 2080), (32, 1), (32, 65), (8, 300), (1, 1024),
    (300, 2048), (16, 4096), (500, 3)])
def test_cache_splits_cover_the_valid_positions(blocks, length):
    """The kernel's cut of [0, length): splits of a multiple of the tile,
    none empty, together exactly covering it; no more of them than give
    two blocks an SM (132 SMs) or than there are tiles."""
    split_len, n = splits(blocks, length, 132)
    assert split_len % TILE == 0
    assert split_len * (n - 1) < length <= split_len * n
    assert 1 <= n <= min(-(-2 * 132 // blocks), -(-length // TILE))


def test_rejects_what_the_kernel_does_not_take():
    q, k, v = map(torch.from_numpy, _inputs(1, 6, 4, 16, 16))
    with pytest.raises(ValueError, match="multiple"):
        decode_attention(q, k, v, 4)          # 6 heads over 4 KV heads
    q, k, v = map(torch.from_numpy, _inputs(1, 4, 2, 16, 16))
    with pytest.raises(TypeError):
        decode_attention(q.double(), k.double(), v.double(), 4)
    with pytest.raises(TypeError, match="host int"):
        decode_attention(q, k, v, torch.tensor(4))


def test_cpu_route_is_the_plain_version():
    """On CPU tensors the wrapper is the plain version, bit for bit, and
    launches nothing; a view of the cache gives what its copy gives."""
    q, k, v = map(torch.from_numpy, _inputs(3, 8, 2, 50, 32, seed=5))
    before = decode_attention.launches
    assert torch.equal(decode_attention(q, k, v, 37),
                       decode_attention_ref(q, k, v, 37))
    assert torch.equal(decode_attention(q, k[:, 5:40], v[:, 5:40], 35),
                       decode_attention(q, k[:, 5:40].contiguous(),
                                        v[:, 5:40].contiguous(), 35))
    assert decode_attention.launches == before


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_kernel_route_refuses_grad_before_any_launch(which):
    """The CUDA route is forward-only: an input that requires grad raises
    NotImplementedError before the kernel is built or launched (so CPU
    tensors reach the guard), while the CPU route keeps its autograd."""
    t = dict(zip("qkv", map(torch.from_numpy, _inputs(2, 4, 2, 32, 16))))
    t[which] = t[which].clone().requires_grad_(True)
    before = decode_attention.launches
    with pytest.raises(NotImplementedError, match="forward-only"):
        dattn._kernel(t["q"], t["k"], t["v"], 20)
    assert decode_attention.launches == before
    decode_attention(t["q"], t["k"], t["v"], 20).sum().backward()
    assert t[which].grad is not None
    assert bool(torch.isfinite(t[which].grad).all())


def test_sdpa_matches_reference(ref):
    """The plain GQA sdpa against the reference's, causal mask."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 10, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, 10, 3, 16)).astype(np.float32)
    v = rng.standard_normal((2, 10, 3, 16)).astype(np.float32)
    mask = np.tril(np.ones((10, 10), bool))[None, None, None]
    want = ref.att.sdpa(*map(ref.jnp.asarray, (q, k, v, mask)))
    got = tatt.sdpa(*map(torch.from_numpy, (q, k, v, mask)))
    _close(got.numpy(), want, 1e-5)


# --- the tensor-core route's numerics (per-warp key runs merged once, bf16
# P) and the route function ---------------------------------------------------

LOG2E = 1.4426950408889634


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _tensor_core_emulation(q, k, v, length, n_sms=132, warps=4, step=16):
    """The tensor-core route of ``csrc/decode_attention.cu`` in float32
    torch: the valid positions cut by ``splits`` as the wrapper cuts them
    for this route; in each split, warp w takes the 16-key steps w, w + 4,
    ... with its own running max, sum and accumulator (logits in the exp2
    domain, keys past the split's end at -1e30, P rounded to bf16 before
    P·V); the warps merged once at the end of the split, then the splits
    by the same rule, as the thread-block cluster merges them. q, k, v
    hold bf16 values."""
    b, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.float().reshape(b, hkv, g, d)
    kf, vf = k.float(), v.float()
    split_len, n_split = splits(b * hkv, length, n_sms,
                                dattn.BLOCKS_PER_SM["tensor_cores"],
                                dattn.MAX_SPLITS["tensor_cores"])
    parts = []
    for s in range(n_split):
        first, end = s * split_len, min(length, (s + 1) * split_len)
        n_steps = -(-(end - first) // step)
        states = []
        for w in range(warps):
            m = torch.full((b, hkv, g), NEG_INF)
            l = torch.zeros(b, hkv, g)
            acc = torch.zeros(b, hkv, g, d)
            for i in range(w, n_steps, warps):
                k0 = first + i * step
                keys = torch.arange(k0, k0 + step)
                kk = kf[:, k0:k0 + step].transpose(1, 2)    # (b,hkv,<=16,d)
                logit = torch.einsum("bkgd,bkjd->bkgj", qg, kk) \
                    * (d ** -0.5 * LOG2E)
                logit = torch.cat([logit, torch.full(
                    (b, hkv, g, step - kk.shape[2]), NEG_INF)], -1)
                logit = logit.masked_fill(keys >= end, NEG_INF)
                mx = torch.maximum(m, logit.amax(-1))
                alpha = torch.exp2(m - mx)
                p = torch.exp2(logit - mx[..., None])
                l = l * alpha + p.sum(-1)
                vv = vf[:, k0:k0 + step].transpose(1, 2)
                pb = _bf16(p[..., :vv.shape[2]])
                acc = acc * alpha[..., None] + torch.einsum(
                    "bkgj,bkjd->bkgd", pb, vv)
                m = mx
            states.append((m, l, acc))
        mx = torch.stack([st[0] for st in states]).amax(0)
        f = [torch.exp2(st[0] - mx) for st in states]
        parts.append((mx, sum(st[1] * fi for st, fi in zip(states, f)),
                      sum(st[2] * fi[..., None] for st, fi in zip(states, f))))
    m = torch.stack([pt[0] for pt in parts]).amax(0)
    f = [torch.exp2(pt[0] - m) for pt in parts]
    lsum = sum(pt[1] * fi for pt, fi in zip(parts, f))
    acc = sum(pt[2] * fi[..., None] for pt, fi in zip(parts, f))
    out = acc / lsum.clamp_min(1e-30)[..., None]
    return _bf16(out.reshape(b, h, d))


@pytest.mark.parametrize("B,H,Hkv,T,D,length", [
    (2, 12, 1, 300, 64, 300),     # G = 12 (starcoder2's), five splits
    (2, 12, 1, 300, 128, 237),    # a ragged tail inside a split
    (8, 16, 16, 80, 32, 77),      # G = 1 (qwen2-moe's), one split
    (1, 1, 1, 2100, 16, 2080),    # G = 1, warps of unequal runs
])
def test_tensor_core_emulation_matches_ref(B, H, Hkv, T, D, length):
    """Per-warp key runs merged once at the end of each split, with P in
    bf16, hold the plain version within the bf16 tolerance 2e-2."""
    q, k, v = (_bf16(t) for t in map(torch.from_numpy,
                                     _inputs(B, H, Hkv, T, D, seed=8)))
    got = _tensor_core_emulation(q, k, v, length)
    want = decode_attention_ref(*(t.to(torch.bfloat16) for t in (q, k, v)),
                                length).float()
    _close(got.numpy(), want.numpy(), TOL["bfloat16"])


@pytest.mark.parametrize("blocks,length", [
    (32, 2064), (128, 2048), (32, 1), (32, 65), (1, 1024), (4, 4096),
    (500, 3)])
def test_tensor_core_splits_cover_the_valid_positions(blocks, length):
    """The tensor-core route's cut of [0, length): the same covering, with
    no more splits than give one block an SM, than there are tiles, or
    than one thread-block cluster holds (8)."""
    per_sm = dattn.BLOCKS_PER_SM["tensor_cores"]
    most = dattn.MAX_SPLITS["tensor_cores"]
    split_len, n = splits(blocks, length, 132, per_sm, most)
    assert split_len % TILE == 0
    assert split_len * (n - 1) < length <= split_len * n
    assert 1 <= n <= min(-(-per_sm * 132 // blocks), -(-length // TILE),
                         most)


def test_route_sends_the_zoo_to_the_tensor_cores():
    """Every attention arch of the zoo at its serving dtype (bf16) takes
    the tensor-core route: G in {1, 5, 7, 8, 12}, D 128."""
    from repro_torch.configs import registry
    groups = set()
    for name in registry.list_archs():
        cfg = registry.get(name)
        if cfg.family == "ssm":
            continue
        g = cfg.n_heads // cfg.n_kv_heads
        groups.add(g)
        assert cfg.head_dim in dattn.HEAD_DIMS, name
        assert dattn.route(torch.bfloat16, g) == "tensor_cores", name
    assert groups == {1, 5, 7, 8, 12}


@pytest.mark.parametrize("dtype,group,aligned", [
    (torch.float32, 12, True),     # float32: the CUDA cores
    (torch.float32, 1, True),
    (torch.float32, 17, True),
    (torch.bfloat16, 12, False),   # not 16-byte aligned
])
def test_route_sends_other_shapes_to_the_cuda_cores(dtype, group, aligned):
    assert dattn.route(dtype, group, aligned) == "cuda_cores"


def test_bfloat16_beyond_one_mma_tile_of_heads_raises():
    """bfloat16 with more than 16 query heads a KV head (no arch of the
    zoo) raises in the wrapper before any build or launch, so CPU tensors
    reach it; the CPU route still serves it."""
    q, k, v = (t.to(torch.bfloat16) for t in map(torch.from_numpy,
                                                 _inputs(1, 17, 1, 32, 16)))
    with pytest.raises(ValueError, match="at most 16"):
        dattn.route(torch.bfloat16, 17)
    before = decode_attention.launches
    with pytest.raises(ValueError, match="at most 16"):
        dattn._kernel(q, k, v, 20)
    assert decode_attention.launches == before
    assert decode_attention(q, k, v, 20).shape == (1, 17, 16)
