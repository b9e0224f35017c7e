"""The port's dry run (``launch/dryrun.py``) and the step-cost plane under
it, against the JAX package where it has a counterpart:

- ``api.input_specs`` has the reference's shapes and dtypes for every arch
  x shape (through ``jax.eval_shape`` of its cache), ``api.init`` on
  ``meta`` the reference's parameter names, shapes and dtypes at full
  width, and ``supports_shape`` the reference's answers;
- a meta trace counts what a real CPU step counts, exactly (FLOPs, bytes
  by operator, live memory and its peak), at reduced configs of every
  family and step kind; the counts grow linearly with depth (the trace
  sees every block: no scan-trip correction), but for a train step's
  gradient of the stacked leaves' per-block ``select``, quadratic
  (ROADMAP P15);
- ``model_flops_total`` is the reference's ``rl.model_flops``, and
  ``yi-34b``'s ``train_4k`` (a full-width trace) puts ~0.68 of its traced
  FLOPs in the 6ND model FLOPs (remat: ~8ND, plus attention);
- the record has the reference's ``lower_pair`` keys; the CLI writes,
  skips and re-runs (``--force``) as the reference's, for one device
  without ``--mesh``, and on the production meshes with ``--mesh
  single``, ``multi`` or ``both`` (in a subprocess: the fake process
  group is global to its process; tests/test_torch_sharded_zoo.py holds
  the sharded trace's counts against a real sharded step);
- ``--cohort`` traces the distributed FEEL round on the fake 16x16 and
  2x16x16 meshes (in a subprocess: the fake process group is global to
  its process), with the all-reduce bytes of (50,890 + 1) float32 a level
  of the hierarchy; and the meta trace of the round counts what a real
  CPU round on a gloo group of one counts;
- nothing touches CUDA.

The reference's ``launch/dryrun.py`` is read, never imported: importing it
sets ``XLA_FLAGS`` for the whole process (512 host devices), and its
compile fails on this jax (ROADMAP R2).
"""
import ast
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from torch_parity import reference

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, InputShape
from repro_torch.convert import flatten_tree
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.models import api

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = registry.list_archs()
PAIRS = [(a, s) for a in ARCHS for s in SHAPES]
# one arch of each family, reduced
FAMILIES = ["yi-34b", "qwen2-moe-a2.7b", "mamba2-370m",
            "jamba-1.5-large-398b", "deepseek-v3-671b", "seamless-m4t-medium"]
KINDS = ["train", "prefill", "decode"]


@pytest.fixture(scope="module")
def ref():
    import jax
    return types.SimpleNamespace(api=reference("models.api"),
                                 reg=reference("configs.registry"),
                                 base=reference("configs.base"),
                                 rl=reference("launch.roofline"), jax=jax)


def _dtype(x) -> str:
    return str(x.dtype).split(".")[-1]


def _leaves(tree):
    return {k: (tuple(v.shape), _dtype(v))
            for k, v in flatten_tree(tree).items()}


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_input_specs_match_reference(ref, arch, shape):
    """Every input of every arch x shape: the same names, shapes and
    dtypes; a decode cache's ``index`` is a host int in the port (an int32
    scalar in the reference), its tensors on ``meta``."""
    want = ref.api.input_specs(ref.reg.get(arch), ref.base.SHAPES[shape])
    got = api.input_specs(registry.get(arch), SHAPES[shape])
    if "cache" in want:
        assert got["cache"]["index"] == 0
        want = {**want, "cache": {k: v for k, v in want["cache"].items()
                                  if k != "index"}}
        got = {**got, "cache": {k: v for k, v in got["cache"].items()
                                if k != "index"}}
    assert _leaves(got) == _leaves(want)
    assert all(t.device.type == "meta"
               for t in flatten_tree(got).values())


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_matches_reference_params(ref, arch):
    """``api.init(device="meta")`` at full width: the reference's
    parameter tree (``jax.eval_shape(api.init)``), name for name, shape
    and dtype; nothing drawn or allocated."""
    want = ref.jax.eval_shape(functools.partial(ref.api.init,
                                                ref.reg.get(arch)),
                              ref.jax.random.PRNGKey(0))
    got = api.init(registry.get(arch), 0, device="meta")
    assert _leaves(got) == _leaves(want)
    assert all(v.device.type == "meta" for v in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_supports_shape_matches_reference(ref, arch):
    for s in SHAPES:
        assert api.supports_shape(registry.get(arch), SHAPES[s]) \
            == ref.api.supports_shape(ref.reg.get(arch), ref.base.SHAPES[s])


def _counts(cfg, kind, device, seq=32, batch=2):
    shape = InputShape("t", seq, batch, kind)
    return dryrun.count_step(*dryrun.step_args(cfg, shape, "adamw", True,
                                               device))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_trace_counts_a_real_cpu_step(arch, kind):
    """The same step on meta tensors and on real CPU tensors (drawn
    weights and tokens) under the same counter: the same FLOPs and bytes,
    operator by operator, and the same live memory."""
    cfg = registry.reduced(registry.get(arch))
    meta, cpu = _counts(cfg, kind, "meta"), _counts(cfg, kind, "cpu")
    assert meta.flops == cpu.flops > 0
    assert meta.op_flops == cpu.op_flops
    assert meta.bytes == cpu.bytes > 0
    assert dict(meta.op_bytes) == dict(cpu.op_bytes)
    assert dict(meta.op_calls) == dict(cpu.op_calls)
    assert meta.memory() == cpu.memory()
    assert meta.peak_bytes > meta.argument_bytes > 0


def _n_blocks(cfg, n):
    kw = dict(n_layers=cfg.first_dense_layers + n * cfg.block_len)
    if cfg.is_encoder_decoder:
        kw["encoder_layers"] = n
    return dataclasses.replace(cfg, **kw)


# the gradient of a stacked leaf's per-block ``select`` is a zero-padded
# copy of the whole stack, summed over the blocks: O(depth^2) bytes
QUADRATIC_IN_TRAINING = {"aten.select_backward", "aten.add"}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ["yi-34b", "deepseek-v3-671b",
                                  "jamba-1.5-large-398b"])
def test_counts_grow_linearly_with_depth(arch, kind):
    """count(3 blocks) - count(2) = count(2) - count(1) for the FLOPs, the
    operator calls and every operator's bytes: the trace sees each block
    once. In a train step but for the gradient of the stacked leaves'
    per-block ``select`` (``select_backward`` and the ``add`` that sums
    it), whose bytes grow with the square of the depth (ROADMAP P15)."""
    cfg = registry.reduced(registry.get(arch))
    c1, c2, c3 = (_counts(_n_blocks(cfg, n), kind, "meta") for n in (1, 2, 3))
    assert c3.flops - c2.flops == c2.flops - c1.flops > 0
    for op in c3.op_calls:
        assert c3.op_calls[op] - c2.op_calls[op] \
            == c2.op_calls[op] - c1.op_calls[op], op
    second = {op: c3.op_bytes[op] - 2 * c2.op_bytes[op] + c1.op_bytes[op]
              for op in c3.op_bytes}
    quadratic = QUADRATIC_IN_TRAINING if kind == "train" else set()
    assert {op for op, d in second.items() if d} == quadratic
    assert all(second[op] > 0 for op in quadratic)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_model_flops_match_reference(ref, arch, shape):
    s = SHAPES[shape]
    tokens = s.global_batch * (s.seq_len if s.kind != "decode" else 1)
    train = s.kind == "train"
    assert rl.model_flops(registry.get(arch), tokens, train) \
        == ref.rl.model_flops(ref.reg.get(arch), tokens, train)


def test_useful_flops_ratio_of_yi_train_4k():
    """yi-34b at train_4k (full width, 60 layers, batch 256, AdamW,
    remat): 6ND model FLOPs over the traced ~8ND (the remat forward runs
    twice) plus attention's, K3's plain VJP in float32 included."""
    rec = dryrun.lower_pair("yi-34b", "train_4k")
    assert rec["status"] == "ok", rec
    assert rec["model_flops_total"] == rl.model_flops(
        registry.get("yi-34b"), 256 * 4096, True)
    assert 0.5 <= rec["useful_flops_ratio"] <= 0.85, rec
    assert rec["optimizer"] == "adamw" and rec["mesh"] == "1xH100"
    assert rec["compute_s"] == rec["flops_per_chip"] / 989e12
    assert rec["memory_s"] == rec["hbm_bytes_per_chip"] / 3.35e12


def _reference_record_keys(ref):
    """The keys of the reference's ``lower_pair`` records, read from its
    source: the ok record's (``rec`` as made, the train shapes'
    ``optimizer``, ``rec.update(status="ok", ..., **terms)``) and the
    skipped one's."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch"
                      / "dryrun.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "lower_pair")
    made = next(n.value for n in ast.walk(fn)
                if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                and getattr(n.targets[0], "id", None) == "rec")
    base = {k.value for k in made.keys if k is not None}
    updates = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
               and getattr(n.func, "attr", None) == "update"]
    by_status = {next(k.value.value for k in u.keywords if k.arg == "status"):
                 {k.arg for k in u.keywords if k.arg} for u in updates}
    terms = set(ref.rl.roofline_terms(1.0, 1.0, {}))
    return (base | {"optimizer"} | by_status["ok"] | terms,
            base | by_status["skipped"])


def test_record_keys_match_reference(ref):
    ok_keys, skip_keys = _reference_record_keys(ref)
    cfg = registry.reduced(registry.get("qwen2-moe-a2.7b"))
    rec = dryrun.lower_pair("qwen2-moe-a2.7b", "train_4k", cfg_override=dataclasses.replace(
        cfg, vocab_size=64), label="qwen2-moe-a2.7b-smoke")
    assert set(rec) == ok_keys, set(rec) ^ ok_keys
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    assert rec["collectives"] == {} and rec["collective_s"] == 0.0
    skipped = dryrun.lower_pair("seamless-m4t-medium", "long_500k")
    assert set(skipped) == skip_keys and skipped["status"] == "skipped"


def test_cli_writes_skips_and_forces(tmp_path, capsys):
    """One arch, every shape (seamless-m4t-medium: three traced, long_500k
    skipped as the reference skips it), appended to --out; a second run
    skips what is there; --force traces again to the same counts."""
    out = tmp_path / "d.json"
    arch = "seamless-m4t-medium"
    assert dryrun.main(["--arch", arch, "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [(r["arch"], r["shape"], r["status"]) for r in recs] == [
        (arch, s, "skipped" if s == "long_500k" else "ok") for s in SHAPES]
    assert all(r["mesh"] == "1xH100" for r in recs)
    assert dryrun.main(["--arch", arch, "--out", str(out),
                        "--no-correction"]) == 0
    assert json.loads(out.read_text()) == recs
    assert dryrun.main(["--arch", arch, "--shape", "decode_32k", "--force",
                        "--out", str(out)]) == 0
    again = json.loads(out.read_text())
    assert len(again) == 4 and again[-1]["shape"] == "decode_32k"
    before = next(r for r in recs if r["shape"] == "decode_32k")
    for key in ("flops_per_chip", "hbm_bytes_per_chip", "memory"):
        assert again[-1][key] == before[key]
    assert "4 records, 0 errors" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--mesh", "multi"], ["--mesh", "both"],
                                  ["--mesh", "multi", "--arch", "yi-34b"]])
def test_cli_writes_the_sharded_plane(ref, tmp_path, argv):
    """The zoo's steps on the production meshes: the mesh arguments that
    were refused before now write ``ok`` records, one a mesh asked for,
    with the reference's keys (a decode step has no ``optimizer``),
    collectives and their roofline term, and the useful FLOPs over every
    chip. The CLI runs in a subprocess (its fake process group is global
    to its process), at decode_32k and on mamba2-370m where no arch is
    named, so that each trace takes seconds."""
    ok_keys, _ = _reference_record_keys(ref)
    out = tmp_path / "d.json"
    arch = [] if "--arch" in argv else ["--arch", "mamba2-370m"]
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv, *arch,
         "--shape", "decode_32k", "--out", str(out)],
        capture_output=True, text=True, timeout=600, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    recs = json.loads(out.read_text())
    want = {"single": ["16x16"], "multi": ["2x16x16"],
            "both": ["16x16", "2x16x16"]}[argv[1]]
    assert [rec["mesh"] for rec in recs] == want
    for rec in recs:
        assert rec["status"] == "ok" and rec["shape"] == "decode_32k"
        assert set(rec) == ok_keys - {"optimizer"}, set(rec) ^ ok_keys
        assert sum(rec["collectives"].values()) > 0
        assert rec["collective_s"] > 0
        chips = 512 if rec["mesh"] == "2x16x16" else 256
        assert rec["useful_flops_ratio"] == pytest.approx(
            rec["model_flops_total"] / (rec["flops_per_chip"] * chips))


def test_no_device_is_touched(monkeypatch):
    """A trace needs no CUDA and initialises none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.reduced(registry.get("mamba2-370m"))
    rec = dryrun.lower_pair("mamba2-370m", "decode_32k", cfg_override=cfg)
    assert rec["status"] == "ok"
    assert not torch.cuda.is_initialized()


def test_decode_is_traced_at_the_last_position():
    """The decode step reads every cached position: K4's cost at length
    S, one more position than a step at index S - 2 would read."""
    cfg = registry.reduced(registry.get("yi-34b"))
    shape = InputShape("t", 64, 2, "decode")
    fn, args = dryrun.step_args(cfg, shape, device="meta")
    assert args[1]["index"] == 63
    full = dryrun.count_step(fn, args)
    fn, args = dryrun.step_args(cfg, shape, device="meta")
    args[1]["index"] = 62
    short = dryrun.count_step(fn, args)
    per_position = 4 * cfg.head_dim * 2 * cfg.n_heads * cfg.n_blocks
    assert full.op_flops["repro_torch.decode_attention"] \
        - short.op_flops["repro_torch.decode_attention"] == per_position


def test_real_inputs_have_the_specs_shapes():
    cfg = registry.reduced(registry.get("seamless-m4t-medium"))
    for kind in KINDS:
        shape = InputShape("t", 16, 2, kind)
        meta = dryrun.step_inputs(cfg, shape, "meta")
        real = dryrun.step_inputs(cfg, shape, "cpu")
        for inputs in (meta, real):
            if "cache" in inputs:
                assert inputs["cache"].pop("index") == 0
        assert _leaves(meta) == _leaves(real)
        if "tokens" in real:
            assert int(real["tokens"].max()) < cfg.vocab_size
    assert np.isfinite(dryrun.step_inputs(
        cfg, InputShape("t", 16, 2, "train"), "cpu")["src"].numpy()).all()


M_MLP = 784 * 64 + 64 + 64 * 10 + 10     # the MLP's 50,890 parameters


def test_cohort_cli(tmp_path):
    """``python -m repro_torch.launch.dryrun --cohort --mesh both``: two
    ``ok`` records with the reference's tags, one all-reduce level a
    client axis (the data group, then the pod group), each moving the
    flattened update and the weight sum in float32."""
    out = tmp_path / "d.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cohort",
         "--mesh", "both", "--out", str(out)], capture_output=True,
        text=True, timeout=600, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "2 records, 0 errors" in r.stdout
    recs = {r["mesh"]: r for r in json.loads(out.read_text())}
    for mesh, shape, levels in (("16x16", "clients_16", 1),
                                ("2x16x16", "clients_32", 2)):
        rec = recs[mesh]
        assert (rec["arch"], rec["shape"], rec["status"]) == (
            "feel-cohort-mlp", shape, "ok")
        assert rec["collectives"] == {
            "all-gather": 0, "all-reduce": (M_MLP + 1) * 4 * levels,
            "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}
        assert rec["collective_s"] == pytest.approx(
            2 * (M_MLP + 1) * 4 * levels / rl.ICI_BW)
        assert rec["collective_s"] > 0 and rec["flops_per_chip"] > 0
        terms = {k: rec[k] for k in ("compute_s", "memory_s",
                                     "collective_s")}
        assert rec["dominant"] == rl.dominant(terms)
    # one client a rank: the same local work on either mesh
    assert recs["16x16"]["flops_per_chip"] == recs["2x16x16"]["flops_per_chip"]


_COHORT_AGREEMENT = r"""
import json, sys, torch
import torch.distributed as dist
from repro_torch.federated.distributed import (cohort_input_specs,
                                               make_cohort_step)
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun import count_step
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.common import MetaGenerator
from repro_torch.models.mlp import mlp_init, mlp_loss

dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                        world_size=1)
try:
    mesh = make_host_mesh(device_type="cpu")
    step = make_cohort_step(mesh, mlp_loss, 0.1, 2)
    shapes = {"x": ((32, 784), torch.float32), "y": ((32,), torch.int64)}
    batch, w, s = cohort_input_specs(mesh, 3, shapes)
    meta = count_step(step, (mlp_init(MetaGenerator(), device="meta"),
                             batch, w, s))
    g = torch.Generator().manual_seed(0)
    real = count_step(step, (
        mlp_init(g), {"x": torch.randn(3, 32, 784, generator=g),
                      "y": torch.randint(10, (3, 32), generator=g)},
        torch.tensor([1.0, 2.0, 3.0]), torch.tensor([1.0, 0.0, 1.0])))
    out = {k: [c.flops, c.bytes, dict(c.op_calls), c.memory(),
               rl.collective_bytes(c.op_collective_bytes)]
           for k, c in (("meta", meta), ("cpu", real))}
finally:
    dist.destroy_process_group()
print(json.dumps(out))
"""


def test_cohort_meta_trace_counts_a_real_round():
    """The dry run's premise for the cohort step: on a gloo group of one,
    the meta trace and a real CPU round (3 clients on the rank, one
    masked) count the same FLOPs, bytes by operator, memory and
    collective bytes — K1 once, one all-reduce."""
    r = subprocess.run([sys.executable, "-c", _COHORT_AGREEMENT],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout)
    assert got["meta"] == got["cpu"]
    ops = got["cpu"][2]
    assert ops["repro_torch.weighted_aggregate"] == 1
    assert ops["c10d.allreduce_"] == 1
    assert got["cpu"][4]["all-reduce"] == (M_MLP + 1) * 4
