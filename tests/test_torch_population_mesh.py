"""The population prefilter split over a mesh
(``prefilter_schedule_runs(..., mesh=)``, ``population_mesh``,
``shard_population``), on gloo ranks on the CPU.

The ranks are spawned by ``torch.multiprocessing`` and meet through a
``FileStore`` under the test's temporary directory (no port, no network),
as in tests/test_torch_distributed.py: world 2 on
``make_host_mesh(device_type="cpu")`` ((2, 1)), world 4 on (4, 1), on
(2, 2) with ``model_parallel=2`` (the "model" coordinate makes a rank a
replica) and on a ("pod", "data") (2, 2) mesh (two data axes). Every rank
writes its outputs; the checks run here.

The instances are tests/test_population.py's generator: ``_instance(11,
8, 160)`` at M = 32 (the reference's own mesh case), the same at N = 161
(uneven shards; one row escalates), N = 40 (every rank holds fewer than M
columns), every row ``max_count`` (integer keys: ties at the M-th key),
M = ``min_selected`` (forced escalation), N = 9 over 4 ranks (a rank
with no column) and NaN reputations of both signs and payloads whose NaN
keys fill the M = 32 prefix of two runs (``nan_keys``; ROADMAP P9).

Tolerances: every output and ``info`` bit for bit against the port's
one-device "device" prefilter; the selections, costs and ``forced``
equal to the exact schedule's; against the reference's one-device
prefilter (``kernel="jax"``, no mesh: R9, below) integers exact and
floats within 4 ulp. No rank's tensors before the output gather are
wider than its (R, ceil(N/d)) columns or the gathered candidates (d
prefixes of min(M, ceil(N/d))), and the path reads the host where the
one-device layout does (the walk's steps).

R9: the reference's own ``mesh=`` call raises ``ShardingTypeError`` under
jax 0.9.0 (4 XLA host devices, in a subprocess); the test pins it, and
fails the day a jax fixes it.
"""
import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch_parity import nan64, reference

from repro_torch.configs.base import FeelConfig
from repro_torch.core import control as ctl
from repro_torch.core import population as pop
from repro_torch.core import scheduler as tsc
from repro_torch.sharding.specs import MeshShape

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
NAMES = ("x", "alpha", "costs", "values", "forced")
POLICIES = list(tsc.POLICY_IDS)

# name: (seed, K, N, M or None for min_selected, every row max_count)
INSTANCES = {
    "base": (11, 8, 160, 32, False),
    "uneven": (11, 8, 161, 32, False),
    "narrow": (5, 8, 40, 32, False),
    "max_count_ties": (7, 8, 160, 32, True),
    "forced_escalation": (11, 8, 160, None, False),
    "empty_block": (3, 8, 9, 6, False),
    "nan_keys": (11, 8, 161, 32, False),
}
# the "nan_keys" instance's NaN reputations (both signs, two payloads):
# (run, candidate, sign, payload), and all but 10 candidates of runs 0
# (dqs) and 4 (top_value), so that NaN keys fill the M = 32 prefix and
# tie across the ranks' blocks
NAN_CELLS = ((1, 5, -1, 0x77), (2, 100, 1, 0), (3, 0, -1, 0),
             (5, 11, 1, 0x77), (5, 160, -1, 0), (9, 20, -1, 0x1234))
NAN_CROWD = (0, 4)
# name: (world, mesh kind)
MESHES = {"host2": (2, "host"), "host4": (4, "host"),
          "replicas": (4, "model2"), "pod_data": (4, "pod")}


def _instance(seed, k, n, r=10, max_count=False):
    """tests/test_population.py's generator (R runs cycling the five
    policies), every row ``max_count`` on request."""
    rng = np.random.default_rng(seed)
    cfg = FeelConfig(n_ues=k, population=n)
    pid = [tsc.POLICY_IDS["max_count" if max_count else POLICIES[i % 5]]
           for i in range(r)]
    state = ctl.ControlState(
        policy_id=np.array(pid, np.int32),
        sizes=rng.uniform(100, 3000, (r, n)),
        divs=rng.uniform(0, 1, (r, n)),
        r_min=rng.uniform(1e4, 1e7, (r, n)),
        reputations=rng.uniform(0, 1, (r, n)),
        ages=rng.integers(1, 10, (r, n)).astype(float), cfg=cfg)
    gains = rng.exponential(1e-9, (r, n))
    rand_rank = np.stack([np.argsort(rng.permutation(n)) for _ in range(r)])
    omega = (np.full(r, cfg.omega_rep), np.full(r, cfg.omega_div))
    return cfg, state, gains, rand_rank, omega


def _case(name):
    seed, k, n, m, mc = INSTANCES[name]
    cfg, state, gains, rand_rank, omega = _instance(seed, k, n,
                                                    max_count=mc)
    if name == "nan_keys":
        for i, j, sign, payload in NAN_CELLS:
            state.reputations[i, j] = nan64(sign, payload)
        rng = np.random.default_rng(n)
        for i in NAN_CROWD:
            for c in rng.choice(n, n - 10, replace=False):
                state.reputations[i, c] = nan64((-1) ** c, c % 3)
    return state, gains, rand_rank, omega, m or cfg.min_selected


def _mesh(kind):
    from torch.distributed.device_mesh import init_device_mesh
    if kind == "pod":
        return init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("pod", "data"))
    return pop.population_mesh(2 if kind == "model2" else 1,
                               device_type="cpu")


class Watch(TorchDispatchMode):
    """The widest 2-D tensor an operator makes, and the host reads."""
    width = 0
    host_reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        res = func(*args, **(kwargs or {}))
        if func is torch.ops.aten._local_scalar_dense.default:
            Watch.host_reads += 1
        if isinstance(res, torch.Tensor) and res.dim() == 2:
            Watch.width = max(Watch.width, res.shape[1])
        return res


def _rank_main(rank, world, store, kinds, out):
    """One gloo rank: every instance on each mesh of this world size;
    writes its outputs, the widest 2-D tensor the mesh path made, its host
    reads, and ``shard_population``'s local blocks."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    real = pop._prefilter_device

    def watched(*a, **k):
        with Watch():
            return real(*a, **k)

    pop._prefilter_device = watched
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        for label in kinds:
            mesh = _mesh(MESHES[label][1])
            res = {"mesh_shape": np.array(tuple(mesh.shape))}
            for name in INSTANCES:
                state, gains, rr, omega, m = _case(name)
                Watch.width = Watch.host_reads = 0
                *outs, info = pop.prefilter_schedule_runs(
                    state, gains, rr, *omega, m=m, mesh=mesh)
                res.update({f"{name}.{k}": v for k, v in zip(NAMES, outs)})
                res[f"{name}.info"] = np.array(
                    [info["m"], info["n_escalated"]])
                res[f"{name}.width"] = np.array(Watch.width)
                res[f"{name}.host_reads"] = np.array(Watch.host_reads)
            state, gains, rr, omega, m = _case("uneven")
            *outs, _ = pop.prefilter_schedule_runs(
                state, gains, rr, *omega, m=m, kernel="hybrid", mesh=mesh)
            res.update({f"hybrid.{k}": v for k, v in zip(NAMES, outs)})
            a, b = pop.shard_population(mesh, state.reputations, rr)
            for key, t, want in (("f64", a, state.reputations),
                                 ("i64", b, rr)):
                assert isinstance(t, DTensor), type(t)
                res[f"shard.{key}.dtype"] = np.array(str(t.dtype))
                res[f"shard.{key}.local"] = t.to_local().numpy()
                res[f"shard.{key}.full"] = t.full_tensor().numpy()
                res[f"shard.{key}.placements"] = np.array(
                    [repr(p) for p in t.placements])
            want = [Shard(1) if n in ("pod", "data") else Replicate()
                    for n in mesh.mesh_dim_names]
            res["shard.placements_ok"] = np.array(
                list(a.placements) == want)
            np.savez(os.path.join(out, f"{label}.{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{mesh label: [each rank's npz]}."""
    out = tmp_path_factory.mktemp("ranks")
    by_world = {}
    for label, (world, _) in MESHES.items():
        by_world.setdefault(world, []).append(label)
    for world, kinds in sorted(by_world.items()):
        store = str(tmp_path_factory.mktemp(f"store{world}") / "store")
        torch.multiprocessing.spawn(_rank_main,
                                    args=(world, store, kinds, str(out)),
                                    nprocs=world, join=True)
    return {label: [np.load(out / f"{label}.{r}.npz", allow_pickle=False)
                    for r in range(world)]
            for label, (world, _) in MESHES.items()}


@pytest.fixture(scope="module")
def one_device():
    """{instance: the port's one-device "device" prefilter, the exact
    "device" schedule, and the one-device layout's host reads}."""
    res = {}
    for name in INSTANCES:
        state, gains, rr, omega, m = _case(name)
        *outs, info = pop.prefilter_schedule_runs(state, gains, rr, *omega,
                                                  m=m, kernel="device")
        exact = ctl.schedule_runs(state, gains, rr, *omega, kernel="device")
        Watch.host_reads = 0
        with Watch():
            pop._prefilter_device(state, gains, rr, *omega, m)
        res[name] = (outs, info, exact, Watch.host_reads)
    return res


@pytest.mark.parametrize("label", list(MESHES))
@pytest.mark.parametrize("name", list(INSTANCES))
def test_mesh_prefilter_is_the_one_device_prefilter(ranks, one_device,
                                                    label, name):
    """Every rank's every output and ``info``, bit for bit, against the
    one-device "device" layout; and its selections, costs and ``forced``
    against the exact schedule."""
    outs, info, exact, _ = one_device[name]
    for r, got in enumerate(ranks[label]):
        for k, want in zip(NAMES, outs):
            a = got[f"{name}.{k}"]
            assert a.dtype == np.asarray(want).dtype, (label, name, r, k)
            np.testing.assert_array_equal(a, want, err_msg=f"{label} {r} {k}")
        assert got[f"{name}.info"].tolist() == [info["m"],
                                                info["n_escalated"]]
        for i in (0, 2, 4):
            np.testing.assert_array_equal(got[f"{name}.{NAMES[i]}"],
                                          exact[i])


def test_the_instances_cover_what_they_name(one_device):
    """Escalation where the instance says so; ties at the M-th key of the
    all-``max_count`` rows; ranks narrower than M."""
    assert one_device["uneven"][1]["n_escalated"] >= 1
    assert one_device["forced_escalation"][1]["n_escalated"] >= 1
    assert one_device["base"][1]["n_escalated"] == 0
    m = INSTANCES["max_count_ties"][3]
    costs = np.sort(one_device["max_count_ties"][0][2], -1)
    assert all(c[m - 1] == c[m] for c in costs)
    x, _, _, values, _ = one_device["nan_keys"][0]
    nan = np.isnan(values)
    assert nan[list(NAN_CROWD)].sum() == 2 * (INSTANCES["nan_keys"][2] - 10)
    assert (x[0] & nan[0]).any() and not (x[4] & nan[4]).any()
    assert math.ceil(INSTANCES["narrow"][2] / 2) < INSTANCES["narrow"][3]
    assert 3 * math.ceil(INSTANCES["empty_block"][2] / 4) == \
        INSTANCES["empty_block"][2]


@pytest.mark.parametrize("label", list(MESHES))
@pytest.mark.parametrize("name", list(INSTANCES))
def test_no_rank_holds_more_than_its_columns(ranks, one_device, label,
                                            name):
    """Before the outputs are gathered, a rank's widest 2-D tensor is its
    (R, ceil(N/d)) block or the gathered prefixes; the host is read where
    the one-device layout reads it (the walk's steps)."""
    world, _ = MESHES[label]
    d = world // (2 if label == "replicas" else 1)
    _, k, n, m, _ = INSTANCES[name]
    m = m or FeelConfig().min_selected
    w = -(-n // d) if label != "pod_data" else -(-(-(-n // 2)) // 2)
    for got in ranks[label]:
        assert int(got[f"{name}.width"]) <= max(w, d * min(m, w)), (
            label, name, int(got[f"{name}.width"]))
        assert int(got[f"{name}.host_reads"]) == one_device[name][3]


def test_hybrid_ignores_the_mesh(ranks):
    """``kernel="hybrid"`` with a mesh is the hybrid layout on one device,
    as the reference's "jax layout only" ``mesh``."""
    state, gains, rr, omega, m = _case("uneven")
    *want, _ = pop.prefilter_schedule_runs(state, gains, rr, *omega, m=m,
                                           kernel="hybrid")
    for label, rks in ranks.items():
        for got in rks:
            for k, w in zip(NAMES, want):
                np.testing.assert_array_equal(got[f"hybrid.{k}"], w)


@pytest.mark.parametrize("label", list(MESHES))
def test_shard_population_places_the_columns(ranks, label):
    """``shard_population``: DTensors split over the data axes and
    replicated over "model", dtypes kept, N = 161 uneven; the local blocks
    are the mesh prefilter's columns and make up the array."""
    state, _, rr, _, _ = _case("uneven")
    world, _ = MESHES[label]
    for r, got in enumerate(ranks[label]):
        assert bool(got["shard.placements_ok"])
        assert str(got["shard.f64.dtype"]) == "torch.float64"
        assert str(got["shard.i64.dtype"]) == "torch.int64"
        np.testing.assert_array_equal(got["shard.f64.full"],
                                      state.reputations)
        np.testing.assert_array_equal(got["shard.i64.full"], rr)
    # the blocks in rank order make up the array (a replica's block is
    # its data neighbour's, so every other rank on the (2, 2) mesh)
    step = 2 if label == "replicas" else 1
    np.testing.assert_array_equal(np.concatenate(
        [got["shard.i64.local"] for got in ranks[label][::step]], 1), rr)


@pytest.fixture(scope="module")
def ref():
    import types
    return types.SimpleNamespace(cfg=reference("configs.base"),
                                 ctl=reference("core.control"),
                                 pop=reference("core.population"))


def _ref_state(ref, state):
    return ref.ctl.ControlState(
        policy_id=state.policy_id.copy(), sizes=state.sizes.copy(),
        divs=state.divs.copy(), r_min=state.r_min.copy(),
        reputations=state.reputations.copy(), ages=state.ages.copy(),
        cfg=ref.cfg.FeelConfig(**dataclasses.asdict(state.cfg)))


def _ulps(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    gap = np.abs(a - b)
    scale = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return float(np.max(gap / scale, initial=0.0))


@pytest.mark.parametrize("name", list(INSTANCES))
def test_mesh_prefilter_against_the_reference(ranks, ref, name):
    """Against the reference's one-device prefilter (its "jax" layout, no
    mesh: R9): integers exact, floats within 4 ulp, the same ``info``.
    With NaN keys against the reference's exact schedule (its "hybrid"
    layout), which its prefilter does not give there (R10): the same
    checks, NaN values where NaN."""
    state, gains, rr, omega, m = _case(name)
    if name == "nan_keys":
        want = ref.ctl.schedule_runs(_ref_state(ref, state), gains, rr,
                                     *omega, kernel="hybrid")
        info = None
    else:
        *want, info = ref.pop.prefilter_schedule_runs(
            _ref_state(ref, state), gains, rr, *omega, m=m, kernel="jax")
    got = ranks["host4"][0]
    for i, k in enumerate(NAMES):
        if i in (0, 2, 4):
            np.testing.assert_array_equal(got[f"{name}.{k}"], want[i])
        else:
            nan = np.isnan(want[i])
            assert np.array_equal(np.isnan(got[f"{name}.{k}"]), nan), k
            assert _ulps(got[f"{name}.{k}"][~nan], want[i][~nan]) <= 4, k
    if info is not None:
        assert got[f"{name}.info"].tolist() == [info["m"],
                                                info["n_escalated"]]


def test_a_mesh_shape_of_one_is_one_device():
    """Without a process group ``population_mesh`` is a (1, 1)
    ``MeshShape``; the mesh path runs on it with no collective, bit-equal
    to the one-device layout. A ``MeshShape`` of more ranks raises."""
    mesh = pop.population_mesh(device_type="cpu")
    assert mesh == MeshShape(("data", "model"), (1, 1))
    state, gains, rr, omega, m = _case("uneven")
    *got, gi = pop.prefilter_schedule_runs(state, gains, rr, *omega, m=m,
                                           mesh=mesh)
    *want, wi = pop.prefilter_schedule_runs(state, gains, rr, *omega, m=m,
                                            kernel="device")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert gi == wi
    with pytest.raises(ValueError, match="DeviceMesh"):
        pop.prefilter_schedule_runs(state, gains, rr, *omega, m=m,
                                    mesh=MeshShape(("data", "model"),
                                                   (2, 1)))


_R9 = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.experimental, numpy as np
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
from repro.configs.base import FeelConfig
from repro.core import control as ctl
from repro.core import population as pop

rng = np.random.default_rng(11)
r, k, n = 10, 8, 160
cfg = FeelConfig(n_ues=k, population=n)
state = ctl.ControlState(
    policy_id=np.array([i % 5 for i in range(r)], np.int32),
    sizes=rng.uniform(100, 3000, (r, n)), divs=rng.uniform(0, 1, (r, n)),
    r_min=rng.uniform(1e4, 1e7, (r, n)),
    reputations=rng.uniform(0, 1, (r, n)),
    ages=rng.integers(1, 10, (r, n)).astype(float), cfg=cfg)
gains = rng.exponential(1e-9, (r, n))
rr = np.stack([np.argsort(rng.permutation(n)) for _ in range(r)])
omega = (np.full(r, cfg.omega_rep), np.full(r, cfg.omega_div))
mesh = pop.population_mesh()
print("DEVICES", mesh.devices.size)
pop.prefilter_schedule_runs(state, gains, rr, *omega, m=32)
print("ONE-DEVICE-OK")
try:
    pop.prefilter_schedule_runs(state, gains, rr, *omega, m=32,
                                kernel="jax", mesh=mesh)
    print("MESH-RAN")
except Exception as e:
    print("RAISED", type(e).__name__)
"""


def test_r9_the_reference_mesh_prefilter_raises():
    """ROADMAP R9: the reference's ``prefilter_schedule_runs(...,
    kernel="jax", mesh=population_mesh())`` raises ``ShardingTypeError``
    on 4 XLA host devices under this jax, where its one-device call runs;
    so the port's mesh path is held against its one-device prefilter."""
    r = subprocess.run([sys.executable, "-c", _R9], capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": SRC,
                            "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "DEVICES 4" in r.stdout and "ONE-DEVICE-OK" in r.stdout
    assert "RAISED ShardingTypeError" in r.stdout, r.stdout
