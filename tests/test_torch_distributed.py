"""Port parity of the distributed FEEL round (``federated/distributed.py``):
the port's ``make_cohort_step`` over gloo ranks on the CPU against the JAX
package's ``make_cohort_step`` (``shard_map`` + ``psum``) and against the
sequential FedAvg of local SGD.

The reference runs once, in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (so its masked and
hierarchical cases, which it skips on one device, run on 2 and 2x2 host
devices); it draws each case's inputs from a numpy seed and its MLP
params from ``mlp_init``, and writes both with its outputs. The port runs
each world size once, in ``torch.multiprocessing`` spawned ranks that meet
through a ``FileStore`` under the test's temporary directory (no port, no
network): world 1 (``("data", "model")`` (1, 1)), world 2 ((2, 1)), world
4 (``("pod", "data")`` (2, 2), and ``("data", "model")`` (2, 2), where the
model coordinate makes a rank a replica). Params cross through
``convert.params_from_numpy``; labels are int32 in the reference and int64
in the port.

Tolerances: 2e-5 abs/rel in float32 (the reference's own test), and
1e-2·max|out| with ``agg_dtype=bfloat16`` (each client's product and the
weight sum rounded to bf16 before the sums, in both packages). An
unselected client's batch replaced by finite garbage leaves the output bit
for bit (0·x adds exactly 0 in K1's float32 sum and in the sums across
ranks).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.federated.distributed import (client_slice,
                                               cohort_input_specs,
                                               make_cohort_step)
from repro_torch.models.mlp import mlp_loss
from repro_torch.sharding.specs import MeshShape

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LEAVES = ("b1", "b2", "w1", "w2")
TOL = dict(atol=2e-5, rtol=2e-5)

# name: (mesh sizes, axis names, client axes, weights, select, lr, local
# steps, agg dtype, seed). The first three are tests/test_distributed.py's
# cases; "mask" is the one it skips on one device.
CASES = {
    "fedavg": ((1, 1), ("data", "model"), ("data",), [1.0], [1.0], 0.1, 3,
               None, 0),
    "mask": ((2, 1), ("data", "model"), ("data",), [1.0, 1.0], [1.0, 0.0],
             0.1, 2, None, 1),
    "identity": ((1, 1), ("data", "model"), ("data",), [1.0], [1.0], 0.05, 1,
                 None, 2),
    "hier_f32": ((2, 2), ("pod", "data"), ("pod", "data"),
                 [1.0, 2.0, 3.0, 4.0], [1.0, 0.0, 1.0, 1.0], 0.1, 2, None, 3),
    "hier_bf16": ((2, 2), ("pod", "data"), ("pod", "data"),
                  [1.0, 2.0, 3.0, 4.0], [1.0, 0.0, 1.0, 1.0], 0.1, 2,
                  "bfloat16", 3),
    "several": ((1, 1), ("data", "model"), ("data",), [3.0, 1.0, 2.0, 5.0],
                [1.0, 0.0, 1.0, 1.0], 0.1, 3, None, 4),
    "replicas": ((2, 2), ("data", "model"), ("data",), [2.0, 3.0],
                 [1.0, 1.0], 0.1, 2, None, 5),
}
# port-only reruns of a case with an unselected client's batch replaced by
# finite garbage: (the case, the client)
GARBAGE = {"several_garbage": ("several", 1), "mask_garbage": ("mask", 1),
           "hier_f32_garbage": ("hier_f32", 1)}

_REFERENCE = r"""
import json, math, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.experimental, jax.numpy as jnp, numpy as np
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
from repro.federated.aggregation import fedavg
from repro.federated.distributed import make_cohort_step
from repro.models.mlp import mlp_init, mlp_loss

cases, out = json.loads(sys.argv[1]), sys.argv[2]
for name, (sizes, axes, caxes, w, s, lr, steps, agg, seed) in cases.items():
    n = len(w)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 64, 784)).astype(np.float32)
    y = rng.integers(0, 10, (n, 64)).astype(np.int32)
    p = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(seed)))
    w, s = np.asarray(w, np.float32), np.asarray(s, np.float32)
    res = {"x": x, "y": y, **{"p_" + k: v for k, v in p.items()}}
    # the reference's own step, on a mesh of its client axes, one client a
    # device
    shape = tuple(z for a, z in zip(axes, sizes) if a in caxes)
    if math.prod(shape) == n:
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                                 tuple(caxes))
        step = make_cohort_step(mesh, mlp_loss, lr, steps, tuple(caxes),
                                jnp.bfloat16 if agg else None)
        o = step(p, {"x": x, "y": y}, w, s)
        res.update({"shard_" + k: np.asarray(v) for k, v in o.items()})
    # the sequential oracle: each client's local SGD, then FedAvg
    if not agg:
        grad = jax.jit(jax.grad(mlp_loss))
        locs = []
        for i in range(n):
            q = p
            for _ in range(steps):
                g = grad(q, {"x": x[i], "y": y[i]})
                q = jax.tree.map(lambda a, b: a - lr * b, q, g)
            locs.append(q)
        e = fedavg(locs, list(w * s))
        res.update({"seq_" + k: np.asarray(v) for k, v in e.items()})
    np.savez(os.path.join(out, name + ".npz"), **res)
print("OK")
"""


def _garbage(x):
    """Finite garbage of the shape of a client's batch."""
    return (5.0 * x[::-1] + 2.0).astype(np.float32)


def _rank_main(rank, world, store, cases, data, out):
    """One gloo rank: every case of this world size, each on its own
    ``DeviceMesh``; writes its output, its client slice and its host reads
    (``aten._local_scalar_dense``) to ``out``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils._python_dispatch import TorchDispatchMode

    class HostReads(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                HostReads.n += 1
            return func(*args, **(kwargs or {}))

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        for name, (case, garbage) in cases.items():
            sizes, axes, caxes, w, s, lr, steps, agg, _ = CASES[case]
            mesh = init_device_mesh("cpu", tuple(sizes),
                                    mesh_dim_names=tuple(axes))
            d = np.load(os.path.join(data, case + ".npz"))
            x, y = d["x"].copy(), d["y"]
            if garbage is not None:
                x[garbage] = _garbage(x[garbage])
            sl = client_slice(mesh, len(w), tuple(caxes))
            params = params_from_numpy({k: d["p_" + k] for k in LEAVES},
                                       "cpu")
            batch = {"x": torch.from_numpy(x[sl]),
                     "y": torch.from_numpy(y[sl].astype(np.int64))}
            step = make_cohort_step(
                mesh, mlp_loss, lr, steps, tuple(caxes),
                torch.bfloat16 if agg else None)
            HostReads.n = 0
            with HostReads():
                got = step(params, batch, torch.tensor(w)[sl],
                           torch.tensor(s)[sl])
            np.savez(os.path.join(out, f"{name}.{rank}.npz"),
                     **params_to_numpy(got),
                     dtypes=np.array([str(got[k].dtype) for k in LEAVES]),
                     slice=np.array([sl.start, sl.stop]),
                     host_reads=np.array(HostReads.n))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: {"ref": the reference's npz, "ranks": [each rank's npz]}}."""
    data = tmp_path_factory.mktemp("reference")
    out = tmp_path_factory.mktemp("port")
    r = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(CASES),
                        str(data)], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": SRC,
                            "JAX_PLATFORMS": "cpu"}, timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    jobs = {name: (name, None) for name in CASES}
    jobs.update({name: (case, client)
                 for name, (case, client) in GARBAGE.items()})
    worlds = {}
    for name, (case, _) in jobs.items():
        worlds.setdefault(int(np.prod(CASES[case][0])), {})[name] = \
            jobs[name]
    for world, cases in sorted(worlds.items()):
        store = str(tmp_path_factory.mktemp(f"store{world}") / "store")
        torch.multiprocessing.spawn(
            _rank_main, args=(world, store, cases, str(data), str(out)),
            nprocs=world, join=True)
    res = {}
    for name, (case, _) in jobs.items():
        world = int(np.prod(CASES[case][0]))
        res[name] = {"ref": np.load(data / f"{case}.npz"),
                     "ranks": [np.load(out / f"{name}.{r}.npz")
                               for r in range(world)]}
    return res


def _close(got, ref, prefix, **tol):
    for k in LEAVES:
        np.testing.assert_allclose(got[k], ref[prefix + k], **tol,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["fedavg", "mask", "identity", "hier_f32",
                                  "replicas"])
def test_matches_reference_shard_map(runs, name):
    """Each rank's output against the reference's step on its own mesh,
    one client a device (hier_f32: the (2, 2) pod x data mesh, masked)."""
    for got in runs[name]["ranks"]:
        _close(got, runs[name]["ref"], "shard_", **TOL)


@pytest.mark.parametrize("name", ["fedavg", "mask", "hier_f32", "several",
                                  "replicas"])
def test_matches_sequential_fedavg(runs, name):
    """Against the sequential FedAvg of each client's local SGD (the
    reference's ``fedavg`` over the masked weights; "several" is four
    clients on one rank, one K1 launch over them)."""
    for got in runs[name]["ranks"]:
        _close(got, runs[name]["ref"], "seq_", **TOL)


def test_identity_case_is_finite(runs):
    """tests/test_distributed.py::test_mask_single_device_identity."""
    for got in runs["identity"]["ranks"]:
        assert all(np.isfinite(got[k]).all() for k in LEAVES)


def test_hierarchical_bf16_aggregation(runs):
    """``agg_dtype=bfloat16`` on the (2, 2) pod x data mesh against the
    reference's, within 1e-2·max|out|; and near the float32 round."""
    ref = runs["hier_bf16"]["ref"]
    f32 = runs["hier_f32"]["ranks"][0]
    for got in runs["hier_bf16"]["ranks"]:
        for k in LEAVES:
            scale = np.abs(ref["shard_" + k]).max()
            np.testing.assert_allclose(got[k], ref["shard_" + k],
                                       atol=1e-2 * scale, rtol=0, err_msg=k)
            np.testing.assert_allclose(got[k], f32[k], atol=1e-2 * scale,
                                       rtol=0, err_msg=k)
        assert list(got["dtypes"]) == ["torch.float32"] * 4


@pytest.mark.parametrize("name", sorted(GARBAGE))
def test_unselected_client_changes_nothing(runs, name):
    """An unselected client's batch replaced by finite garbage: the
    output is bit-equal (on its own rank, on another rank, across pods)."""
    case = GARBAGE[name][0]
    for got, want in zip(runs[name]["ranks"], runs[case]["ranks"]):
        for k in LEAVES:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(set(CASES) | set(GARBAGE)))
def test_every_rank_holds_the_same_output(runs, name):
    ranks = runs[name]["ranks"]
    for got in ranks[1:]:
        for k in LEAVES:
            np.testing.assert_array_equal(got[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_client_slices_and_no_host_read(runs, name):
    """Rank r holds the block its coordinate on the client axes (in mesh
    order) gives, as the reference's ``shard_map`` deals the clients; a
    replica (its model coordinate) the same block as its data peer; and
    the step reads no value back to the host."""
    sizes, axes, caxes, w, *_ = CASES[name]
    n_blocks = int(np.prod([z for a, z in zip(axes, sizes) if a in caxes]))
    n_local = len(w) // n_blocks
    coords = np.array(np.unravel_index(np.arange(int(np.prod(sizes))),
                                       sizes)).T
    for r, got in enumerate(runs[name]["ranks"]):
        block = 0
        for a, z, c in zip(axes, sizes, coords[r]):
            if a in caxes:
                block = block * z + c
        assert list(got["slice"]) == [block * n_local,
                                      (block + 1) * n_local], (r, name)
        assert int(got["host_reads"]) == 0


def test_cohort_input_specs_are_one_ranks_share():
    mesh = MeshShape(("pod", "data", "model"), (2, 16, 16))
    batch, w, s = cohort_input_specs(
        mesh, 64, {"x": ((256, 784), torch.float32),
                   "y": ((256,), torch.int64)}, ("pod", "data"))
    assert batch["x"].shape == (2, 256, 784) and batch["x"].is_meta
    assert batch["y"].dtype == torch.int64 and batch["y"].shape == (2, 256)
    assert w.shape == s.shape == (2,) and w.dtype == torch.float32
    with pytest.raises(ValueError, match="do not split"):
        cohort_input_specs(mesh, 33, {}, ("pod", "data"))


def test_cohort_step_needs_the_client_axes():
    with pytest.raises(ValueError, match="not an axis"):
        make_cohort_step(MeshShape(("data", "model"), (1, 1)), mlp_loss,
                         0.1, 1, client_axes=("pod", "data"))
