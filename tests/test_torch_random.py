"""``repro_torch.random`` against ``jax.random`` (threefry2x32, with
``jax_threefry_partitionable``, jax 0.9's default) on the CPU.

Bit for bit: ``PRNGKey``, ``split`` (flat and nested), ``bits`` (scalar,
odd 1-D, 2-D and 3-D shapes), the hash on counter words whose hi word is
not zero (jax's ``threefry_2x32`` on the same words: no test can allocate
the 2^32 elements that reach it through a flat index), ``bits`` across the
flat index 2^32, ``uniform`` and ``truncated_normal``, whose float32 steps
are XLA's CPU code (erf, log1p, erf_inv, with the fused multiply-adds its
CPU backend emits); no value of a truncated draw reaches a bound. The
chunked draw equals the draw in one piece, ``meta`` draws nothing, and a
key's default device is the card.
"""
import numpy as np
import pytest
import torch
from torch_parity import reference  # noqa: F401  (the R1 alias)

from repro_torch import random as rnd

SEEDS = [0, 1, 2**31 - 1]


@pytest.fixture(scope="module")
def jr():
    import jax
    return jax


def _key(seed):
    return rnd.PRNGKey(seed, "cpu")


def assert_same_bits(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want, np.float32).view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches(jr, seed):
    got = _key(seed)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    assert got.tolist() == np.asarray(jr.random.PRNGKey(seed)).tolist()


def test_prng_key_keeps_the_hi_word_as_jax_under_x64(jr):
    seed = 2**40 + 3
    with jr.enable_x64(True):
        want = np.asarray(jr.random.PRNGKey(seed)).tolist()
    assert want[0] == 256
    assert _key(seed).tolist() == want


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 3, 8])
def test_split_matches(jr, seed, num):
    got = rnd.split(_key(seed), num)
    assert got.shape == (num, 2) and got.dtype == torch.int64
    want = np.asarray(jr.random.split(jr.random.PRNGKey(seed), num))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("path", [(3, 1, 4), (2, 0, 2, 1), (8, 7, 5, 4)])
def test_nested_split_matches(jr, path):
    """Split by path[0], take subkey path[1], split that by path[2], ...:
    the initializers' tree of splits."""
    got, want = _key(0), jr.random.PRNGKey(0)
    for num, pick in zip(path[::2], path[1::2]):
        got = rnd.split(got, num)[pick]
        want = jr.random.split(want, num)[pick]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(), (7,), (1001,), (5, 3), (2, 3, 4)])
@pytest.mark.parametrize("seed", [0, 2**31 - 1])
def test_bits_match(jr, shape, seed):
    got = rnd.bits(_key(seed), shape)
    assert tuple(got.shape) == shape and got.dtype == torch.int64
    want = np.asarray(jr.random.bits(jr.random.PRNGKey(seed), shape))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, n, np.uint64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threefry_with_a_nonzero_hi_word_matches(jr, seed):
    """The hash on (hi, lo) counter words, hi ranging over all 32 bits,
    against jax's ``threefry_2x32`` on the same words (it hashes the
    first half of its count array as the hi words of the second)."""
    from jax._src import prng
    n = 257
    key = _words(2, seed)
    hi, lo = _words(n, seed + 10), _words(n, seed + 20)
    hi[:4] = [1, 2**31, 2**32 - 1, 0]
    got0, got1 = rnd.threefry2x32(
        torch.from_numpy(key.astype(np.int64)),
        torch.from_numpy(hi.astype(np.int64)),
        torch.from_numpy(lo.astype(np.int64)))
    want = np.asarray(prng.threefry_2x32(
        key.astype(np.uint32), np.concatenate([hi, lo]).astype(np.uint32)))
    np.testing.assert_array_equal(got0.numpy(), want[:n].astype(np.int64))
    np.testing.assert_array_equal(got1.numpy(), want[n:].astype(np.int64))


def test_bits_past_flat_index_two_to_the_32(jr):
    """A draw of more than 2^32 elements reaches counters with hi word 1:
    the port's bits at flat indices 2^32 - 3 .. 2^32 + 2 are jax's hash of
    those counter words, xor-ed."""
    from jax._src import prng
    start, stop = 2**32 - 3, 2**32 + 3
    key = _key(5)
    got = rnd._to_u32(rnd._bits_i32(key, start, stop)).numpy()
    idx = np.arange(start, stop, dtype=np.uint64)
    hi, lo = (idx >> np.uint64(32)).astype(np.uint32), (
        idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    assert hi.tolist() == [0, 0, 0, 1, 1, 1]
    out = np.asarray(prng.threefry_2x32(np.asarray(key.numpy(), np.uint32),
                                        np.concatenate([hi, lo])))
    np.testing.assert_array_equal(got, (out[:6] ^ out[6:]).astype(np.int64))


@pytest.mark.parametrize("shape,lo,hi", [((1001,), 0.0, 1.0),
                                         ((37, 5), -2.0, 3.0),
                                         ((64, 64), -0.9973002, 0.9973002)])
def test_uniform_matches_bit_for_bit(jr, shape, lo, hi):
    got = rnd.uniform(_key(3), shape, lo, hi)
    assert_same_bits(got, jr.random.uniform(jr.random.PRNGKey(3), shape,
                                            np.float32, lo, hi))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("lower,upper", [(-3.0, 3.0), (-2.0, 2.0),
                                         (-1.0, 2.5)])
def test_truncated_normal_matches_bit_for_bit(jr, seed, lower, upper):
    shape = (512, 512)
    got = rnd.truncated_normal(_key(seed), lower, upper, shape)
    assert_same_bits(got, jr.random.truncated_normal(
        jr.random.PRNGKey(seed), lower, upper, shape, np.float32))
    assert got.min() > lower and got.max() < upper


def test_truncated_normal_scale_and_dtype_act_after_the_draw():
    key, std = _key(7), 1.0 / np.sqrt(48)
    plain = rnd.truncated_normal(key, -3.0, 3.0, (48, 40))
    want = (plain * float(np.float32(std))).to(torch.bfloat16)
    got = rnd.truncated_normal(key, -3.0, 3.0, (48, 40), scale=std,
                               dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_chunked_draw_equals_one_piece(monkeypatch):
    key = _key(11)
    whole = [rnd.bits(key, (97, 31)), rnd.truncated_normal(key, -3, 3,
                                                           (97, 31))]
    monkeypatch.setitem(rnd.CHUNK, "cpu", 500)
    parts = [rnd.bits(key, (97, 31)), rnd.truncated_normal(key, -3, 3,
                                                           (97, 31))]
    assert all(torch.equal(a, b) for a, b in zip(whole, parts))


def test_meta_draws_nothing():
    key = rnd.PRNGKey(0, "meta")
    assert key.device.type == "meta"
    ks = rnd.split(key, 3)
    assert ks.shape == (3, 2) and ks.device.type == "meta"
    t = rnd.truncated_normal(ks[0], -3, 3, (4096, 4096), scale=0.5,
                             dtype=torch.bfloat16)
    assert t.device.type == "meta" and t.dtype == torch.bfloat16
    assert tuple(t.shape) == (4096, 4096)


def test_prng_key_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rnd.PRNGKey(0)


def test_the_module_imports_no_jax():
    import ast
    import pathlib
    tree = ast.parse(pathlib.Path(rnd.__file__).read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not names & {"jax", "jaxlib", "repro"}, names
