"""Port parity of ``launch/train.py`` on a mesh (``--host-mesh``,
``--multi-pod``): the reference's launcher shards its train state by the
rules and runs its step on the mesh; the port's places the state as
``DTensor``s by ``param_specs`` / ``opt_state_specs`` and each batch by
(the data axes, None).

Four gloo ranks spawned by ``torch.multiprocessing`` (a ``FileStore``
under the test's temporary directory: no port, no network), each calling
``main`` in process with ``--host-mesh``: the (4, 1) ("data", "model")
mesh over the group. The one-device runs are ``main`` in the test's
process. Reduced ``qwen2-moe-a2.7b`` in float32 (``--smoke``), batch 4 x
32, AdamW: the losses within 1e-5 (relative) of the one-device run's, a
checkpoint written on the mesh equal bit for bit to the state it was
taken from, and checkpoints crossing between the mesh and one device
both ways (each resumed run's loss within 1e-5 of the uninterrupted
one-device run's).
"""
import json
import os
import time

import pytest
import torch

from repro_torch.checkpoint import restore
from repro_torch.launch import train as train_cli

SMOKE = ["--arch", "qwen2-moe-a2.7b", "--smoke", "--batch", "4", "--seq",
         "32", "--device", "cpu", "--ckpt-every", "2"]
LOSS_TOL = 1e-5
SPAWN_S = 240


def _rank(rank, world, store, tmp):
    import logging
    import warnings
    import torch.distributed as dist
    warnings.filterwarnings("ignore")
    logging.disable(logging.WARNING)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.sharding.dtensor import full
    mesh = ["--host-mesh"]
    res = {}
    # two steps on the mesh, a checkpoint at step 2
    a = train_cli.main(SMOKE + mesh + ["--steps", "2", "--ckpt",
                                       f"{tmp}/mesh_ck"])
    res["a"] = [float(full({"l": m["loss"]})["l"]) for m in a["metrics"]]
    params, opt_state, step = a["state"]
    params, opt_state = full(params), full(opt_state)
    res["placements"] = sorted({str(v.placements) for v in
                                a["state"][0].values()})
    dist.barrier()
    if rank == 0:
        saved, meta = restore(f"{tmp}/mesh_ck", (params, opt_state, step))
        res["saved_step"] = meta["step"]
        res["saved_equal"] = (
            all(torch.equal(saved[0][k], params[k]) for k in params)
            and all(torch.equal(saved[1][k], opt_state[k])
                    for k in opt_state)
            and torch.equal(saved[2], step))
    # the third step, resumed on the mesh from the mesh's checkpoint
    b = train_cli.main(SMOKE + mesh + ["--steps", "1", "--ckpt",
                                       f"{tmp}/mesh_ck"])
    res["b"] = [float(full({"l": m["loss"]})["l"]) for m in b["metrics"]]
    # the third step, resumed on the mesh from a one-device checkpoint
    c = train_cli.main(SMOKE + mesh + ["--steps", "1", "--ckpt",
                                       f"{tmp}/device_ck"])
    res["c"] = [float(full({"l": m["loss"]})["l"]) for m in c["metrics"]]
    # --multi-pod needs the 2x16x16 mesh's 512 ranks
    try:
        train_cli.main(SMOKE + ["--multi-pod", "--steps", "1"])
        res["multi_pod"] = None
    except SystemExit as e:
        res["multi_pod"] = str(e)
    if rank == 0:
        with open(f"{tmp}/ranks.json", "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    torch.set_num_threads(1)
    device = train_cli.main(SMOKE + ["--steps", "3"])
    # a one-device checkpoint at step 2, for the mesh to resume from
    train_cli.main(SMOKE + ["--steps", "2", "--ckpt", str(tmp / "device_ck")])
    ctx = torch.multiprocessing.spawn(
        _rank, args=(4, str(tmp / "store"), str(tmp)), nprocs=4, join=False)
    deadline = time.monotonic() + SPAWN_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the mesh's ranks ran past {SPAWN_S} s")
    ranks = json.loads((tmp / "ranks.json").read_text())
    # the third step on one device, resumed from the mesh's checkpoint
    crossed = train_cli.main(SMOKE + ["--steps", "1", "--ckpt",
                                      str(tmp / "mesh_ck")])
    return {"device": [float(m["loss"]) for m in device["metrics"]],
            "ranks": ranks,
            "crossed": [float(m["loss"]) for m in crossed["metrics"]]}


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_TOL * abs(w), (got, want)


def test_mesh_run_matches_one_device(runs):
    """Two steps on the (4, 1) mesh: the losses of the one-device run's
    first two; the state is made of ``DTensor``s split over "data"."""
    _close(runs["ranks"]["a"], runs["device"][:2])
    assert any("Shard" in p for p in runs["ranks"]["placements"])


def test_mesh_checkpoint_is_the_state_bit_for_bit(runs):
    """Rank 0 writes the full tensors at step 2, in ``checkpoint/io.py``'s
    layout: restored into plain tensors they equal the gathered state of
    the run bit for bit."""
    assert runs["ranks"]["saved_step"] == 2
    assert runs["ranks"]["saved_equal"] is True


def test_mesh_resumes_its_own_checkpoint(runs):
    _close(runs["ranks"]["b"], runs["device"][2:])


@pytest.mark.parametrize("way", ["device_to_mesh", "mesh_to_device"])
def test_checkpoints_cross_between_mesh_and_device(runs, way):
    """A one-device checkpoint resumed on the mesh, and the mesh's
    resumed on one device: the third step's loss is the uninterrupted
    one-device run's."""
    got = runs["ranks"]["c"] if way == "device_to_mesh" else runs["crossed"]
    _close(got, runs["device"][2:])


def test_multi_pod_needs_512_ranks(runs, capsys):
    """On the 4-rank group, and with no group (a group of one is opened
    and closed): a clear error naming the 512 ranks."""
    assert "512 ranks" in runs["ranks"]["multi_pod"]
    assert "has 4" in runs["ranks"]["multi_pod"]
    with pytest.raises(SystemExit, match="512 ranks.*has 1"):
        train_cli.main(SMOKE + ["--multi-pod", "--steps", "1"])
    assert not torch.distributed.is_initialized()


def test_host_mesh_first_line_names_the_mesh(tmp_path, capsys):
    """Without ``torchrun`` ``--host-mesh`` opens a group of one (gloo on
    the CPU, an in-memory store) and closes it; the first line prints the
    mesh, as the reference's does."""
    out = train_cli.main(SMOKE + ["--host-mesh", "--steps", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("mesh {'data': 1, 'model': 1}  arch "
                        "qwen2-moe-a2.7b-smoke  batch 4 seq 32  opt adamw")
    assert lines[-1] == "done" and not torch.distributed.is_initialized()
    assert len(out["metrics"]) == 1
