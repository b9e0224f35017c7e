"""The port's hillclimb (``launch/hillclimb.py``) against the
reference's: each variant's config equal to the reference's
``apply_variant``'s field by field, the optimizer override the same,
``moe_disp`` and ``moe_local<g>`` traced on the production mesh with the
reference's spec dicts (in the port's layouts), ``--multi-pod``, an
unknown variant a ``KeyError``; ``remat_off`` and ``donate`` reach only
their own variant, where the reference's leak into every later variant
of the call through ``os.environ`` (ROADMAP R8, pinned here); the CLI.

The reference's ``launch/hillclimb.py`` runs in a subprocess: importing
it sets ``XLA_FLAGS`` for the process, and its ``remat_off`` and
``donate`` set environment variables that stay set.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.configs import registry
from repro_torch.launch import dryrun, hillclimb

ROOT = pathlib.Path(__file__).resolve().parents[1]
# (variant, arch): each variant on an arch it applies to
VARIANTS = [("baseline", "yi-34b"), ("chunk64", "mamba2-370m"),
            ("chunk128", "mamba2-370m"), ("chunk512", "jamba-1.5-large-398b"),
            ("ssd_bf16", "mamba2-370m"), ("ssd_bf16+chunk128", "mamba2-370m"),
            ("bf16_opt", "yi-34b"), ("f32_params", "qwen2.5-32b"),
            ("pad_vocab", "qwen2-moe-a2.7b"), ("remat_off", "yi-34b"),
            ("donate", "starcoder2-15b"), ("moe_local4", "qwen2-moe-a2.7b"),
            ("moe_local8+bf16_opt", "deepseek-v3-671b"),
            ("moe_disp", "qwen2-moe-a2.7b")]

_REFERENCE = r'''
import dataclasses, json, os, sys
import jax
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
from repro.configs import get
from repro.launch import hillclimb
out = {}
for variant, arch in json.loads(sys.argv[1]):
    cfg, kwargs = get(arch), {}
    env = {}
    for atom in variant.split("+"):
        cfg = hillclimb.apply_variant(atom, cfg, kwargs)
    out[variant + "@" + arch] = dict(
        cfg=json.loads(json.dumps(dataclasses.asdict(cfg))),
        kwargs=sorted(kwargs),
        optimizer=kwargs.get("optimizer_override"),
        env={k: os.environ.get(k) for k in ("REPRO_REMAT_OFF",
                                            "REPRO_DONATE")})
try:
    hillclimb.apply_variant("no_such_variant", get("yi-34b"), {})
except KeyError as e:
    out["unknown"] = str(e)
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference_variants():
    """The reference's ``apply_variant`` over ``VARIANTS`` in one
    subprocess, in order: each variant's config, kwargs and the two
    environment variables after it."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    env.pop("REPRO_REMAT_OFF", None)
    env.pop("REPRO_DONATE", None)
    out = subprocess.run([sys.executable, "-c", _REFERENCE,
                          json.dumps(VARIANTS)], capture_output=True,
                         text=True, check=True, env=env, cwd=ROOT)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port(variant, arch):
    cfg, kwargs = registry.get(arch), {}
    for atom in variant.split("+"):
        cfg = hillclimb.apply_variant(atom, cfg, kwargs)
    return cfg, kwargs


@pytest.mark.parametrize("variant,arch", VARIANTS)
def test_variant_config_matches_reference(reference_variants, variant,
                                          arch):
    """Field by field, sub-configs included; the optimizer override of
    ``bf16_opt``."""
    want = reference_variants[f"{variant}@{arch}"]
    cfg, kwargs = _port(variant, arch)
    assert json.loads(json.dumps(dataclasses.asdict(cfg))) == want["cfg"]
    assert kwargs.get("optimizer_override") == want["optimizer"]


def test_unknown_variant_raises_keyerror(reference_variants):
    assert "no_such_variant" in reference_variants["unknown"]
    with pytest.raises(KeyError, match="no_such_variant"):
        hillclimb.apply_variant("no_such_variant", registry.get("yi-34b"),
                                {})


def test_variant_needing_a_sub_config_raises():
    with pytest.raises(ValueError, match="SSM"):
        hillclimb.apply_variant("chunk128", registry.get("yi-34b"), {})
    with pytest.raises(ValueError, match="MoE"):
        hillclimb.apply_variant("moe_local4", registry.get("yi-34b"), {})


# The CLI on the production meshes, in a subprocess (the dry run's fake
# process group is global to its process), the configs reduced as
# ``_reduced`` does; decode_32k, whose trace on 2x16x16 takes seconds
_MESH_RUNS = r"""
import json, sys
from repro_torch.configs import registry
from repro_torch.launch import dryrun, hillclimb
real = registry.get
hillclimb.registry.get = lambda arch: registry.reduced(real(arch))
out = sys.argv[1]
moe = ["--arch", "qwen2-moe-a2.7b", "--shape", "decode_32k", "--variants",
       "baseline,moe_disp,moe_local4"]
assert hillclimb.main(moe + ["--out", out + "/single.json"]) == 0
assert hillclimb.main(moe + ["--multi-pod", "--out", out + "/multi.json"]) == 0
assert hillclimb.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                       "--multi-pod", "--out", out + "/mamba.json"]) == 0
base = dryrun.lower_pair("qwen2-moe-a2.7b", "decode_32k", False,
                         cfg_override=registry.reduced(
                             real("qwen2-moe-a2.7b")))
json.dump(base, open(out + "/base16.json", "w"))
print("OK")
"""


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    r = subprocess.run([sys.executable, "-c", _MESH_RUNS, str(out)],
                       capture_output=True, text=True, timeout=600, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                            "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    return {name: json.loads((out / f"{name}.json").read_text())
            for name in ("single", "multi", "mamba", "base16")}


def _coll(rec):
    return {k: v for k, v in rec["collectives"].items() if v}


def test_moe_disp_is_an_ok_record_on_the_mesh(mesh_runs):
    """``moe_disp`` sets activation specs, so it traces on the reference's
    16x16 pod, where they take effect: an ``ok`` record whose collectives
    differ from the baseline's on the same mesh; the baseline alone keeps
    the one-device trace."""
    base, disp, local = mesh_runs["single"]
    assert (disp["arch"], disp["shape"], disp["mesh"], disp["variant"],
            disp["status"]) == ("qwen2-moe-a2.7b", "decode_32k", "16x16",
                                "moe_disp", "ok")
    assert base["mesh"] == "1xH100" and base["collectives"] == {}
    assert local["mesh"] == "16x16" and local["status"] == "ok"
    want = mesh_runs["base16"]
    assert want["mesh"] == "16x16" and _coll(want)
    assert _coll(disp) != _coll(want)
    assert _coll(local) != _coll(want)


def test_multi_pod_moe_variants_change_the_collectives(mesh_runs):
    """``--multi-pod`` puts every variant on 2x16x16; ``moe_disp`` and
    ``moe_local4`` move other bytes than the baseline (the dispatch
    buffer pinned to the experts' split: all-to-alls appear)."""
    base, disp, local = mesh_runs["multi"]
    assert {r["mesh"] for r in (base, disp, local)} == {"2x16x16"}
    assert all(r["status"] == "ok" for r in (base, disp, local))
    assert _coll(disp) != _coll(base) and _coll(local) != _coll(base)
    assert disp["collectives"]["all-to-all"] > \
        base["collectives"]["all-to-all"]


# the reference's spec functions, on its production meshes (its hillclimb
# sets 512 host devices when imported)
_REFERENCE_SPECS = r"""
import json, sys
import jax
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
from repro.configs import get
from repro.launch import hillclimb
from repro.launch.mesh import make_production_mesh
out = {}
for arch in ("qwen2-moe-a2.7b", "deepseek-v3-671b"):
    for variant in ("moe_disp", "moe_local4"):
        for multi in (False, True):
            kwargs = {}
            cfg = hillclimb.apply_variant(variant, get(arch), kwargs)
            specs = kwargs["extra_specs_fn"](
                make_production_mesh(multi_pod=multi), cfg)
            out[f"{arch}/{variant}/{multi}"] = {
                k: [list(e) if isinstance(e, tuple) else e for e in v]
                for k, v in specs.items()}
print(json.dumps(out))
"""


def _as_port_layout(name, spec):
    """A reference spec in the port's layout for ``name``: the
    group-local buffer (G, E, C, ·) is the port's (E, G·C, ·), so G's and
    E's entries trade places and C (never split by these specs) merges
    into G."""
    if name == "moe_disp4a":
        g, e, c, d = spec
        assert c is None
        return [e, g, d]
    if len(spec) == 4:                       # (None, E, None, ·)
        assert spec[0] is None and spec[2] is None
        return [spec[1], None, spec[3]]
    return spec


def test_moe_spec_dicts_match_the_reference():
    """``moe_disp``'s and ``moe_local<g>``'s spec dicts against the
    reference's ``apply_variant``'s, run in a subprocess: the same names,
    and each spec the reference's in the port's layout
    (``_as_port_layout``), for an expert count that divides the mesh
    (DeepSeek's 256) and one that does not (Qwen's 60), on both meshes."""
    from repro_torch.sharding.specs import MeshShape
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _REFERENCE_SPECS],
                         capture_output=True, text=True, check=True,
                         env=env, cwd=ROOT, timeout=300)
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    meshes = {False: MeshShape(("data", "model"), (16, 16)),
              True: MeshShape(("pod", "data", "model"), (2, 16, 16))}
    for key, want in ref.items():
        arch, variant, multi = key.split("/")
        kwargs = {}
        cfg = hillclimb.apply_variant(variant, registry.get(arch), kwargs)
        got = kwargs["extra_specs_fn"](meshes[multi == "True"], cfg)
        assert set(got) == set(want), key
        for name, spec in want.items():
            port = [list(e) if isinstance(e, tuple) else e
                    for e in got[name]]
            assert port == _as_port_layout(name, spec), (key, name)


def test_reference_leaks_remat_off_and_donate(reference_variants):
    """ROADMAP R8, the reference's fault: ``remat_off`` and ``donate`` set
    ``REPRO_REMAT_OFF`` / ``REPRO_DONATE`` in ``os.environ`` and nothing
    unsets them, so every later variant of the same call has them: the
    variants after ``remat_off`` in ``VARIANTS`` still see it, and its
    dry run reads both at every lowering."""
    seen = [reference_variants[f"{v}@{a}"]["env"] for v, a in VARIANTS]
    first_off = [v for v, _ in VARIANTS].index("remat_off")
    assert all(e["REPRO_REMAT_OFF"] is None for e in seen[:first_off])
    assert all(e["REPRO_REMAT_OFF"] == "1" for e in seen[first_off:])
    first_donate = [v for v, _ in VARIANTS].index("donate")
    assert all(e["REPRO_DONATE"] == "1" for e in seen[first_donate:])
    source = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    assert 'os.environ.get("REPRO_REMAT_OFF"' in source
    assert 'os.environ.get("REPRO_DONATE", "0") == "1"' in source


def _reduced(monkeypatch):
    """The hillclimb's configs, reduced: full-width traces are the dry run's
    tests' business."""
    real = registry.get
    monkeypatch.setattr(hillclimb.registry, "get",
                        lambda arch: registry.reduced(real(arch)))


def test_remat_off_reaches_its_own_variant_only(monkeypatch, tmp_path):
    """``remat_off,baseline,donate``: the first record without remat
    (fewer FLOPs: no recomputed forward), the baseline after it with
    remat, ``donate`` equal to it; neither sets an environment
    variable."""
    _reduced(monkeypatch)
    out = tmp_path / "perf.json"
    assert hillclimb.main(["--arch", "mamba2-370m", "--shape", "train_4k",
                           "--variants", "remat_off,baseline,donate",
                           "--out", str(out)]) == 0
    assert not {"REPRO_REMAT_OFF", "REPRO_DONATE"} & set(os.environ)
    off, base, donate = json.loads(out.read_text())
    assert [r["variant"] for r in (off, base, donate)] == [
        "remat_off", "baseline", "donate"]
    assert off["flops_per_chip"] < base["flops_per_chip"]
    for key in ("flops_per_chip", "hbm_bytes_per_chip", "memory"):
        assert donate[key] == base[key]


def test_cli_records_and_replaces_variants(monkeypatch, tmp_path, capsys,
                                          mesh_runs):
    """Two ``ok`` records for ``baseline,ssd_bf16`` (the bf16-compute scan:
    the same FLOPs, other bytes: its plain backward in bf16); a variant run
    again replaces its record; ``--multi-pod`` writes an ``ok`` record on
    2x16x16 (in ``mesh_runs``' subprocess: decode_32k)."""
    _reduced(monkeypatch)
    out = tmp_path / "perf.json"
    argv = ["--arch", "mamba2-370m", "--shape", "train_4k", "--out",
            str(out)]
    assert hillclimb.main(argv + ["--variants", "baseline,ssd_bf16"]) == 0
    base, bf16 = json.loads(out.read_text())
    assert base["status"] == bf16["status"] == "ok"
    assert bf16["flops_per_chip"] == base["flops_per_chip"]
    assert bf16["hbm_bytes_per_chip"] != base["hbm_bytes_per_chip"]
    assert hillclimb.main(argv + ["--variants", "ssd_bf16"]) == 0
    assert [r["variant"] for r in json.loads(out.read_text())] == [
        "baseline", "ssd_bf16"]
    (rec,) = mesh_runs["mamba"]
    assert (rec["arch"], rec["mesh"], rec["variant"], rec["status"]) == (
        "mamba2-370m", "2x16x16", "baseline", "ok")
    assert rec["collective_s"] > 0


def test_records_are_the_dry_runs(monkeypatch):
    """A variant's record is ``dryrun.lower_pair``'s with the variant
    tag."""
    _reduced(monkeypatch)
    rec = hillclimb.run_variant("yi-34b", "prefill_32k", "baseline")
    want = dryrun.lower_pair("yi-34b", "prefill_32k",
                             cfg_override=registry.reduced(
                                 registry.get("yi-34b")))
    for key in ("flops_per_chip", "hbm_bytes_per_chip", "memory", "status"):
        assert rec[key] == want[key]
    assert rec["variant"] == "baseline"
