"""Port parity of the sharding plane: ``sharding/specs.py``'s partition
rules against the JAX package's entry for entry, their DTensor placements,
``sharding/ctx.py``'s ``constrain``, ``launch/mesh.py``'s builders and
``launch/roofline.collective_bytes``.

The reference runs in a subprocess with 512 fake host devices, as
tests/test_sharding.py does (``XLA_FLAGS`` is fixed at jax's first use),
and returns its ``param_specs``, ``opt_state_specs`` and ``batch_specs``
for every arch of ``list_archs()`` on the (16, 16) and (2, 16, 16)
production meshes as JSON, with ``NamedSharding(mesh, spec).shard_shape``
of every leaf. The port's rules run here, on ``MeshShape``s and the
``meta`` trees of ``api.init`` and ``api.cache_init``. A second subprocess
starts torch's ``fake`` process group (256, then 512 ranks; it is global
to its process, so it never runs in a test worker) and there builds the
meshes as ``DeviceMesh``es, places every leaf with ``distribute_tensor``,
runs ``constrain`` on ``DTensor``s and counts collectives with the dry
run's ``StepCounter``.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import api
from repro_torch.optim import make_optimizer
from repro_torch.sharding import ctx, specs
from repro_torch.sharding.specs import MeshShape

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"16x16": MeshShape(("data", "model"), (16, 16)),
          "2x16x16": MeshShape(("pod", "data", "model"), (2, 16, 16))}
ARCHS = registry.list_archs()
OPTIMIZERS = ("adamw", "adafactor", "momentum", "sgd")
PLACED_OPTIMIZERS = ("adamw", "adafactor")

_REFERENCE = r"""
import functools, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import SHAPES, TrainConfig, get, list_archs
from repro.launch.mesh import make_production_mesh
from repro.models import api
from repro.optim import make_optimizer
from repro.sharding.specs import (_cache_shape_tree, batch_specs,
                                  opt_state_specs, param_specs)


def key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def flat(tree, is_leaf=None):
    return {key(p): l for p, l in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def spec_json(s):
    return [list(e) if isinstance(e, tuple) else e for e in s]


out = {}
params = {a: jax.eval_shape(functools.partial(api.init, get(a)),
                            jax.random.PRNGKey(0)) for a in list_archs()}
caches = {(a, s): flat(_cache_shape_tree(get(a), SHAPES[s]))
          for a in list_archs() for s in SHAPES
          if SHAPES[s].kind == "decode"}
for name, multi in (("16x16", False), ("2x16x16", True)):
    mesh = make_production_mesh(multi_pod=multi)
    out[name] = {}
    for arch in list_archs():
        cfg, p = get(arch), params[arch]
        rec = {"opt": {}, "batch": {}, "shard": {}}
        shard = rec["shard"]

        def place(prefix, spec_tree, shapes):
            specs = flat(spec_tree, lambda x: isinstance(x, P))
            for k, s in specs.items():
                shp = tuple(shapes[k])
                if shp:
                    shard[prefix + k] = list(
                        NamedSharding(mesh, s).shard_shape(shp))
            return {k: spec_json(s) for k, s in specs.items()}

        pshape = {k: v.shape for k, v in flat(p).items()}
        ps = param_specs(cfg, p, mesh)
        rec["params"] = place("params/", ps, pshape)
        for opt in ("adamw", "adafactor", "momentum", "sgd"):
            st = jax.eval_shape(
                make_optimizer(TrainConfig(optimizer=opt)).init, p)
            rec["opt"][opt] = place(
                f"opt/{opt}/", opt_state_specs(opt, p, ps, mesh),
                {k: v.shape for k, v in flat(st).items()})
        for sname, shape in SHAPES.items():
            b, S = shape.global_batch, shape.seq_len
            if shape.kind == "decode":
                shapes = {"token": (b, 1), **{
                    "cache/" + k: v.shape
                    for k, v in caches[(arch, sname)].items()}}
            else:
                shapes = {"tokens": (b, S),
                          "src": (b, min(S, 4096), cfg.d_model)}
            rec["batch"][sname] = place(f"batch/{sname}/",
                                        batch_specs(cfg, shape, mesh), shapes)
        out[name][arch] = rec
json.dump(out, sys.stdout)
"""

_FAKE = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun import StepCounter
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import api
from repro_torch.optim import make_optimizer
from repro_torch.sharding import activation_specs, constrain, named, specs

archs, optimizers = json.loads(sys.argv[1]), json.loads(sys.argv[2])


def builders():
    def desc(m):
        s = specs.mesh_shape(m)
        return [type(m).__name__, list(s.axis_names), list(s.sizes)]
    return {"production": desc(make_production_mesh(device_type="cpu")),
            "production_multi": desc(make_production_mesh(
                multi_pod=True, device_type="cpu")),
            "host": desc(make_host_mesh(device_type="cpu")),
            "host_mp16": desc(make_host_mesh(16, device_type="cpu")),
            "host_mp3": desc(make_host_mesh(3, device_type="cpu"))}


def local_shapes(mesh):
    out = {}
    shape_mesh = specs.mesh_shape(mesh)
    for arch in archs:
        cfg = registry.get(arch)
        p = api.init(cfg, device="meta")
        ps = specs.param_specs(cfg, p, mesh)
        assert ps == specs.param_specs(cfg, p, shape_mesh)
        leaves = {"params/" + k: (v.shape, ps[k]) for k, v in p.items()}
        for opt in optimizers:
            st = make_optimizer(TrainConfig(optimizer=opt)).init(p)
            os_ = specs.opt_state_specs(opt, p, ps, mesh)
            leaves.update({f"opt/{opt}/{k}": (st[k].shape, os_[k])
                           for k in st})
        for sname, shape in SHAPES.items():
            bs = specs.batch_specs(cfg, shape, mesh)
            ins = api.input_specs(cfg, shape)
            if shape.kind == "decode":
                leaves[f"batch/{sname}/token"] = (ins["token"].shape,
                                                  bs["token"])
                leaves.update({f"batch/{sname}/cache/{k}": (v.shape,
                                                            bs["cache"][k])
                               for k, v in ins["cache"].items()
                               if isinstance(v, torch.Tensor)})
            else:
                leaves.update({f"batch/{sname}/{k}": (v.shape, bs[k])
                               for k, v in ins.items()})
        out[arch] = {}
        for k, (shp, spec) in leaves.items():
            if len(shp) == 0:
                continue
            d = distribute_tensor(torch.empty(shp, device="meta"), mesh,
                                  named(mesh, spec))
            out[arch][k] = list(d.to_local().shape)
    return out


def constrain_cases(mesh):
    x = distribute_tensor(torch.empty(32, 64, 128, device="meta"), mesh,
                          [Replicate()] * mesh.ndim)
    res = {"outside": constrain(x, "act") is x}
    with activation_specs({"act": ("data", None, "model")}):
        y = constrain(x, "act")
        res["placements"] = [f"Shard({p.dim})" if p.is_shard()
                             else type(p).__name__ for p in y.placements]
        res["local"] = list(y.to_local().shape)
        plain = torch.empty(3, 4)
        res["plain"] = constrain(plain, "act") is plain
        res["other_name"] = constrain(x, "logits") is x
    for label, spec in (("unknown_axis", ("pod", None, None)),
                        ("too_many_entries", ("data", None, None, None)),
                        ("axis_twice", ("data", "data", None))):
        with activation_specs({"act": spec}):
            try:
                constrain(x, "act")
            except ValueError as e:
                res[label] = str(e)
            else:
                res[label] = None
    return res


def collectives(mesh):
    with StepCounter() as c:
        dist.all_reduce(torch.empty(64, 64, device="meta"))
        for _ in range(2):
            dist.all_reduce(torch.empty(32, 32, device="meta"),
                            group=mesh.get_group("data"))
        world = dist.get_world_size()
        dist.all_gather_into_tensor(
            torch.empty(1024, 256, dtype=torch.bfloat16, device="meta"),
            torch.empty(1024 // world, 256, dtype=torch.bfloat16,
                        device="meta"))
        dist.reduce_scatter_tensor(
            torch.empty(16, 256, dtype=torch.bfloat16, device="meta"),
            torch.empty(16 * world, 256, dtype=torch.bfloat16,
                        device="meta"))
        dist.all_to_all_single(torch.empty(8, 8, device="meta"),
                               torch.empty(8, 8, device="meta"),
                               group=mesh.get_group("pod"))
    x = distribute_tensor(torch.empty(4096, 128, device="meta"), mesh,
                          [Replicate(), Shard(0), Replicate()])
    with StepCounter() as d:
        x.redistribute(mesh, [Replicate()] * 3)
    return {"c10d": dict(c.op_collective_bytes),
            "c10d_priced": rl.collective_bytes(c.op_collective_bytes),
            "dtensor": dict(d.op_collective_bytes),
            "dtensor_priced": rl.collective_bytes(d.op_collective_bytes)}


out = {}
for name, world, multi in (("16x16", 256, False), ("2x16x16", 512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        assert isinstance(mesh, DeviceMesh), mesh
        out[name] = {"builders": builders(), "local": local_shapes(mesh),
                     "constrain": constrain_cases(mesh)}
        if multi:
            out[name]["collectives"] = collectives(mesh)
    finally:
        dist.destroy_process_group()
json.dump(out, sys.stdout)
"""


def _run(code, *argv):
    r = subprocess.run([sys.executable, "-c", code, *argv],
                       capture_output=True, text=True, timeout=900,
                       env={**os.environ, "PYTHONPATH": SRC,
                            "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout)


@pytest.fixture(scope="module")
def ref():
    return _run(_REFERENCE)


@pytest.fixture(scope="module")
def fake():
    return _run(_FAKE, json.dumps(ARCHS), json.dumps(PLACED_OPTIMIZERS))


def _json(spec_tree):
    """Specs as the reference's JSON: tuples as lists."""
    if isinstance(spec_tree, dict):
        return {k: _json(v) for k, v in spec_tree.items()}
    return [list(e) if isinstance(e, tuple) else e for e in spec_tree]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


_PORT = {}


def _port(arch):
    """(meta params, {mesh: param specs}) of ``arch``, built once."""
    if arch not in _PORT:
        cfg = registry.get(arch)
        p = api.init(cfg, device="meta")
        _PORT[arch] = p, {m: specs.param_specs(cfg, p, mesh)
                          for m, mesh in MESHES.items()}
    return _PORT[arch]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(ref, arch, mesh):
    _, ps = _port(arch)
    assert _json(ps[mesh]) == ref[mesh][arch]["params"]


@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_equal_the_reference(ref, arch, mesh, opt):
    """Keyed as the port's optimizer state (``m/<leaf>``,
    ``s/<leaf>/vr``…), which is the reference's tree flattened."""
    p, ps = _port(arch)
    got = specs.opt_state_specs(opt, p, ps[mesh], MESHES[mesh])
    assert set(got) == set(make_optimizer(TrainConfig(optimizer=opt))
                           .init(p))
    assert _json(got) == ref[mesh][arch]["opt"][opt]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_the_reference(ref, arch, mesh, shape):
    got = specs.batch_specs(registry.get(arch), SHAPES[shape], MESHES[mesh])
    assert _flat(_json(got)) == ref[mesh][arch]["batch"][shape]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_placements_give_the_reference_shard_shapes(ref, fake, arch, mesh):
    """Every leaf of the params, the AdamW and Adafactor states and every
    shape's batch: ``distribute_tensor(meta, mesh, named(mesh, spec))``'s
    local shape on the fake ``DeviceMesh`` equals the reference's
    ``NamedSharding(mesh, spec).shard_shape``."""
    want = {k: v for k, v in ref[mesh][arch]["shard"].items()
            if not k.startswith(("opt/momentum/", "opt/sgd/"))}
    assert fake[mesh]["local"][arch] == want


def test_zero_shard_adds_data_axis():
    """tests/test_sharding.py::test_zero_shard_adds_data_axis."""
    mesh = MeshShape(("data", "model"), (4, 2))
    assert specs._zero_shard((None, "model"), (16, 8), mesh) == (
        "data", "model")
    # refuses non-divisible
    assert specs._zero_shard((None, "model"), (3, 8), mesh) == (
        None, "model")


def test_named_gives_one_placement_a_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MESHES["2x16x16"]
    assert specs.named(mesh, (("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert specs.named(mesh, ()) == [Replicate()] * 3
    assert specs.named(mesh, {"a": ("model",), "b": {"c": (None, "data")}}) \
        == {"a": [Replicate(), Replicate(), Shard(0)],
            "b": {"c": [Replicate(), Shard(1), Replicate()]}}
    with pytest.raises(ValueError, match="not one of"):
        specs.named(MESHES["16x16"], ("pod",))
    with pytest.raises(ValueError, match="for dims"):
        specs.named(mesh, ("data", "data"))


def test_a_one_axis_tuple_is_the_bare_name():
    """As ``PartitionSpec`` writes it (``P("model", None, ("data",))`` is
    ``P("model", None, "data")``): the expert rule on one pod."""
    assert specs._expert_spec("wg", (60, 2048, 1408), MESHES["16x16"]) == (
        "model", None, "data")
    assert specs._expert_spec("wd", (256, 2048, 7168),
                              MESHES["16x16"]) == (("data", "model"), None,
                                                   None)
    assert specs._expert_spec("wd", (256, 2048, 7168),
                              MESHES["2x16x16"]) == ("model",
                                                     ("pod", "data"), None)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_constrain_redistributes_a_dtensor(fake, mesh):
    res = fake[mesh]["constrain"]
    n = 16
    assert res["outside"] and res["plain"] and res["other_name"]
    want = (["Replicate", "Shard(0)", "Shard(2)"]
            if mesh == "2x16x16" else ["Shard(0)", "Shard(2)"])
    assert res["placements"] == want
    assert res["local"] == [32 // n, 64, 128 // n]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_constrain_raises_on_a_spec_that_cannot_apply(fake, mesh):
    res = fake[mesh]["constrain"]
    assert "more entries" in res["too_many_entries"]
    assert "for dims" in res["axis_twice"]
    if mesh == "16x16":
        assert "not one of" in res["unknown_axis"]
    else:
        assert res["unknown_axis"] is None     # this mesh has a pod axis


def test_constrain_is_the_identity_outside_a_context():
    x = torch.randn(4, 8)
    assert ctx.constrain(x, "act") is x
    with ctx.activation_specs({"act": ("data", None)}):
        assert ctx.constrain(x, "act") is x     # a plain tensor


def test_activation_specs_nest_and_restore():
    assert ctx._specs() == {}
    with ctx.activation_specs({"act": ("data",), "dec": (None,)}):
        with ctx.activation_specs({"act": ("model",), "logits": ()}):
            assert ctx._specs() == {"act": ("model",), "dec": (None,),
                                    "logits": ()}
        assert ctx._specs() == {"act": ("data",), "dec": (None,)}
    with pytest.raises(RuntimeError):
        with ctx.activation_specs({"act": ("data",)}):
            raise RuntimeError
    assert ctx._specs() == {}


def test_mesh_builders_without_a_group():
    import torch.distributed as dist
    assert not (dist.is_available() and dist.is_initialized())
    assert make_production_mesh() == MESHES["16x16"]
    assert make_production_mesh(multi_pod=True) == MESHES["2x16x16"]
    assert make_host_mesh() == MeshShape(("data", "model"), (1, 1))
    assert make_host_mesh(4) == MeshShape(("data", "model"), (1, 1))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_builders_with_a_group(fake, mesh):
    """A ``DeviceMesh`` where the group has the mesh's ranks (the fake
    group of 256 or 512), else the ``MeshShape``."""
    b = fake[mesh]["builders"]
    single = mesh == "16x16"
    assert b["production"] == [
        "DeviceMesh" if single else "MeshShape", ["data", "model"], [16, 16]]
    assert b["production_multi"] == [
        "MeshShape" if single else "DeviceMesh", ["pod", "data", "model"],
        [2, 16, 16]]
    world = 256 if single else 512
    assert b["host"] == ["DeviceMesh", ["data", "model"], [world, 1]]
    assert b["host_mp16"] == ["DeviceMesh", ["data", "model"],
                              [world // 16, 16]]
    assert b["host_mp3"] == ["MeshShape", ["data", "model"], [world // 3, 3]]


def test_collective_bytes_counts():
    """tests/test_roofline.py::test_collective_bytes_parsing's byte counts,
    from torch's collective operators as ``StepCounter`` records them."""
    out = rl.collective_bytes({"c10d._allgather_base_": 1024 * 256 * 2,
                               "c10d.allreduce_": 64 * 64 * 4 + 2 * 32 * 32
                               * 4,
                               "c10d._reduce_scatter_base_": 16 * 256 * 2,
                               "c10d.alltoall_base_": 8 * 8 * 4})
    assert out == {"all-gather": 1024 * 256 * 2,
                   "all-reduce": 64 * 64 * 4 + 2 * 32 * 32 * 4,
                   "reduce-scatter": 16 * 256 * 2, "all-to-all": 8 * 8 * 4,
                   "collective-permute": 0}
    with pytest.raises(KeyError):
        rl.collective_bytes({"aten.add": 4})


def test_step_counter_records_the_collectives(fake):
    """The same collectives run under the fake group: the process group's
    ``c10d`` operators, and a DTensor redistribute (functional
    ``all_gather_into_tensor`` of the full (4,096, 128) float32 tensor)."""
    c = fake["2x16x16"]["collectives"]
    assert c["c10d_priced"] == {"all-gather": 1024 * 256 * 2,
                                "all-reduce": 64 * 64 * 4 + 2 * 32 * 32 * 4,
                                "reduce-scatter": 16 * 256 * 2,
                                "all-to-all": 8 * 8 * 4,
                                "collective-permute": 0}
    assert c["c10d"]["c10d.allreduce_"] == 64 * 64 * 4 + 2 * 32 * 32 * 4
    assert c["dtensor"] == {
        "_c10d_functional.all_gather_into_tensor": 4096 * 128 * 4}
    assert c["dtensor_priced"]["all-gather"] == 4096 * 128 * 4
    terms = rl.roofline_terms(0.0, 1.0, c["c10d_priced"])
    assert terms["collective_s"] == pytest.approx(
        (1024 * 256 * 2 + 2 * (64 * 64 * 4 + 2 * 32 * 32 * 4)
         + 16 * 256 * 2 + 8 * 8 * 4) / rl.ICI_BW)


_NAMES = ("act", "logits", "dec", "moe_gather", "moe_disp", "moe_hidden",
          "moe_local", "moe_disp4a", "moe_disp4", "moe_hidden4", "moe_out4")
_GROUPED = {"moe_local", "moe_disp4a", "moe_disp4", "moe_hidden4",
            "moe_out4"}
_GLOBAL = {"moe_gather", "moe_disp", "moe_hidden"}


class _Seen(dict):
    """A spec table that registers nothing and records each name looked
    up."""

    def __init__(self, seen):
        super().__init__()
        self.seen = seen

    def get(self, name, default=None):
        self.seen.add(name)
        return default


def _serve(cfg, src):
    """A reduced arch's prefill of 2 x 16 tokens, one decode step and its
    loss on the CPU: (logits, decode logits, loss)."""
    from repro_torch.launch import steps
    params = api.init(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(cfg.vocab_size, (2, 16), generator=g,
                                     dtype=torch.int32)}
    if src:
        batch["src"] = torch.randn(2, 12, cfg.d_model, generator=g)
    logits, cache = steps.make_prefill_step(cfg)(params, batch,
                                                 target_len=20)
    step_logits, _ = steps.make_decode_step(cfg)(
        params, cache, batch["tokens"][:, -1:])
    loss, _ = api.loss(cfg, params, batch)
    return logits, step_logits, loss


@pytest.mark.parametrize("arch,grouped,prefill_names,decode_names", [
    ("qwen2-moe-a2.7b", False, {"act", "logits"} | _GLOBAL,
     {"dec"} | _GLOBAL),
    ("qwen2-moe-a2.7b", True, {"act", "logits"} | _GROUPED,
     {"dec"} | _GLOBAL),
    ("deepseek-v3-671b", True, {"act", "logits"} | _GROUPED,
     {"dec"} | _GLOBAL),
    ("seamless-m4t-medium", False, {"act", "logits"}, {"dec"}),
    ("mamba2-370m", False, {"act", "logits"}, {"dec"}),
])
def test_constrain_points_are_named_and_move_no_bit(
        monkeypatch, arch, grouped, prefill_names, decode_names):
    """The models call ``constrain`` at the reference's points (the
    group-local MoE dispatch's names where the tokens split into groups:
    prefill's 32 tokens in 2 groups; a decode step's 2 tokens take the
    global dispatch, as in the reference). Inside a context that registers
    every name, plain tensors pass untouched: the same bits and the same
    operators as outside one."""
    from repro_torch.launch.dryrun import StepCounter
    cfg = registry.reduced(registry.get(arch))
    if grouped:
        cfg = registry.optimized(cfg, data_axis_size=2)
    src = cfg.is_encoder_decoder
    seen = {"prefill": set(), "decode": set()}
    from repro_torch.launch import steps
    params = api.init(cfg, 0, device="cpu")
    batch = {"tokens": torch.randint(cfg.vocab_size, (2, 16),
                                     generator=torch.Generator().manual_seed(1),
                                     dtype=torch.int32)}
    if src:
        batch["src"] = torch.randn(2, 12, cfg.d_model)
    with monkeypatch.context() as m:
        m.setattr(ctx, "_specs", lambda: _Seen(seen["prefill"]))
        _, cache = steps.make_prefill_step(cfg)(params, batch, target_len=20)
        m.setattr(ctx, "_specs", lambda: _Seen(seen["decode"]))
        steps.make_decode_step(cfg)(params, cache, batch["tokens"][:, -1:])
    assert seen == {"prefill": prefill_names, "decode": decode_names}

    with StepCounter() as outside:
        plain = _serve(cfg, src)
    with ctx.activation_specs({n: (None,) for n in _NAMES}):
        with StepCounter() as inside:
            pinned = _serve(cfg, src)
    for a, b in zip(plain, pinned):
        assert torch.equal(a, b)
    assert inside.op_calls == outside.op_calls
    assert inside.bytes == outside.bytes
