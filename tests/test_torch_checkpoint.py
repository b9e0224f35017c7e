"""Port parity of ``repro_torch.checkpoint`` against
``repro.checkpoint``: tests/test_checkpoint.py's cases on the port;
checkpoints crossing between the packages bit for bit (a tree with
bfloat16, float32 and a 0-d int32 leaf, and a zoo train state — params,
AdamW's or Adafactor's moments and the step — each written by one package
and restored by the other); and the port's msgpack codec against the
msgpack package (present on this machine, absent on the card's): the
bytes it writes for the reference's payloads are msgpack's, and it reads
what msgpack writes. Everything here is exact: no tolerance.
"""
import json
import types

import numpy as np
import pytest
import torch
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.checkpoint import restore, save
from repro_torch.checkpoint import io as cio
from repro_torch.checkpoint.io import latest_step, load_pytree, save_pytree
from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import train_state_from_numpy
from repro_torch.launch.steps import init_state


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    import msgpack
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, msgpack=msgpack, ck=reference("checkpoint"),
        io=reference("checkpoint.io"), configs=reference("configs"),
        steps=reference("launch.steps"))


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16) * 1.5,
                  "d": torch.tensor(7, dtype=torch.int32)}}


def _ref_tree(ref):
    jnp = ref.jnp
    return {"a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
            "b": {"c": jnp.ones((5,), jnp.bfloat16) * 1.5,
                  "d": jnp.asarray(7, jnp.int32)}}


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# ---------------------------------------------------------------------- #
# tests/test_checkpoint.py's cases, on the port
# ---------------------------------------------------------------------- #
def test_roundtrip(tmp_path):
    t = _tree()
    p = str(tmp_path / "x.msgpack")
    save_pytree(t, p)
    out = load_pytree(t, p)
    assert _equal(out["a"], t["a"]) and _equal(out["b"]["c"], t["b"]["c"])
    assert _equal(out["b"]["d"], t["b"]["d"])


def test_step_management(tmp_path):
    d = str(tmp_path / "ckpt")
    t = _tree()
    save(d, 10, t, {"note": "first"})
    save(d, 20, t)
    assert latest_step(d) == 20
    state, meta = restore(d, t)
    assert meta["step"] == 20
    state, meta = restore(d, t, step=10)
    assert meta["note"] == "first"


def test_restore_empty(tmp_path):
    state, meta = restore(str(tmp_path / "none"), _tree())
    assert state is None and meta is None


def test_load_refuses_a_tree_it_does_not_fit(tmp_path):
    p = str(tmp_path / "x.msgpack")
    save_pytree(_tree(), p)
    with pytest.raises(ValueError, match="leaves"):
        load_pytree({"a": torch.zeros(3, 4)}, p)
    bad = _tree()
    bad["a"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="does not match"):
        load_pytree(bad, p)
    bad["a"] = torch.zeros(3, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="does not match"):
        load_pytree(bad, p)


# ---------------------------------------------------------------------- #
# Across the packages
# ---------------------------------------------------------------------- #
def test_a_reference_checkpoint_restores_in_the_port(ref, tmp_path):
    ref.ck.save(str(tmp_path), 3, _ref_tree(ref), {"note": "ref"})
    state, meta = restore(str(tmp_path), _tree())
    assert meta == {"step": 3, "note": "ref"}
    want = _tree()
    assert _equal(state["a"], want["a"])
    assert _equal(state["b"]["c"], want["b"]["c"])
    assert _equal(state["b"]["d"], want["b"]["d"])


def test_a_port_checkpoint_restores_in_the_reference(ref, tmp_path):
    save(str(tmp_path), 5, _tree(), {"note": "port"})
    state, meta = ref.ck.restore(str(tmp_path), _ref_tree(ref))
    assert meta == {"step": 5, "note": "port"}
    for a, b in zip(ref.jax.tree.leaves(state),
                    ref.jax.tree.leaves(_ref_tree(ref))):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(np.asarray(a, np.float32),
                              np.asarray(b, np.float32))
    # the same payload as the reference writes, but for the treedef text
    ref.io.save_pytree(_ref_tree(ref), str(tmp_path / "r.msgpack"))
    mine = ref.msgpack.unpackb(
        (tmp_path / "00000005" / "state.msgpack").read_bytes(), raw=False)
    theirs = ref.msgpack.unpackb((tmp_path / "r.msgpack").read_bytes(),
                                 raw=False)
    assert mine["leaves"] == theirs["leaves"]


@pytest.mark.parametrize("arch,opt", [("qwen2-moe-a2.7b", "adamw"),
                                      ("jamba-1.5-large-398b", "adafactor"),
                                      ("mamba2-370m", "sgd")])
def test_train_states_cross_both_ways(ref, tmp_path, arch, opt):
    """A zoo train state (bfloat16 params, float32 moments, int32 step)
    written by the reference restores in the port leaf for leaf and bit for
    bit, and the port's in the reference."""
    rcfg = ref.configs.reduced(ref.configs.get(arch))
    rstate = ref.steps.init_state(rcfg, ref.configs.TrainConfig(
        optimizer=opt), ref.jax.random.PRNGKey(3))
    rstate = (rstate[0], rstate[1], rstate[2] + 7)
    ref.ck.save(str(tmp_path / "r"), 7, rstate)
    cfg = registry.reduced(registry.get(arch))
    like = init_state(cfg, TrainConfig(optimizer=opt), 0, device="cpu")
    got, meta = restore(str(tmp_path / "r"), like)
    want = train_state_from_numpy(ref.jax.tree.map(np.asarray, rstate),
                                  "cpu")
    assert meta == {"step": 7}
    for a, b in zip(got[:2], want[:2]):
        assert set(a) == set(b)
        assert all(_equal(a[k], b[k]) for k in b)
    assert _equal(got[2], want[2]) and int(got[2]) == 7
    # and back: the port writes, the reference restores
    save(str(tmp_path / "p"), 7, got)
    back, _ = ref.ck.restore(str(tmp_path / "p"), rstate)
    for a, b in zip(ref.jax.tree.leaves(back), ref.jax.tree.leaves(rstate)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------- #
# The codec
# ---------------------------------------------------------------------- #
PAYLOADS = [
    {"leaves": [{"dtype": "float32", "shape": [], "data": b"\0" * 4}],
     "treedef": "PyTreeDef(*)"},
    {"a": 1, "b": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                   2 ** 32, 2 ** 64 - 1], "s": "x" * 31, "t": "y" * 32,
     "u": "z" * 256, "w": "é" * 40_000},
    {"bin": [b"", b"q" * 255, b"r" * 256, b"s" * 70_000],
     "arr": list(range(16)), "m": {str(i): [i] for i in range(17)}},
    [[[]] * 3, {}, {"k": {"l": [1, [2, [3]]]}}],
]


@pytest.mark.parametrize("obj", PAYLOADS, ids=range(len(PAYLOADS)))
def test_codec_matches_msgpack(ref, obj):
    """The codec writes msgpack's bytes for every size class of map,
    array, str, bin and non-negative int, and reads what msgpack
    writes."""
    packed = ref.msgpack.packb(obj, use_bin_type=True)
    assert cio.packb(obj) == packed
    assert cio.unpackb(packed) == ref.msgpack.unpackb(packed, raw=False)


def test_codec_refuses_what_the_reference_never_writes(ref):
    for obj in (-1, 1.5, None, True):
        with pytest.raises(TypeError):
            cio.packb(obj)
    with pytest.raises(ValueError, match="unsupported"):
        cio.unpackb(ref.msgpack.packb(1.5))
    with pytest.raises(ValueError, match="after"):
        cio.unpackb(ref.msgpack.packb(1) + b"\x01")


def test_meta_is_json(tmp_path):
    save(str(tmp_path), 12, _tree(), {"arch": "yi-34b"})
    assert json.loads((tmp_path / "00000012" / "meta.json").read_text()) \
        == {"step": 12, "arch": "yi-34b"}


def test_bfloat16_is_stored_as_its_bits(tmp_path, ref):
    x = torch.tensor([1.0, -2.5, 3.1415], dtype=torch.bfloat16)
    save_pytree({"x": x}, str(tmp_path / "b.msgpack"))
    leaf = ref.msgpack.unpackb((tmp_path / "b.msgpack").read_bytes(),
                               raw=False)["leaves"][0]
    assert leaf["dtype"] == "bfloat16" and leaf["shape"] == [3]
    assert leaf["data"] == x.view(torch.int16).numpy().tobytes()
