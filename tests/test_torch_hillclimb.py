"""The port's hillclimb (``launch/hillclimb.py``) against the
reference's: each variant's config equal to the reference's
``apply_variant``'s field by field, the optimizer override the same,
``moe_disp`` a skipped record naming the sharded plane, an unknown
variant a ``KeyError``; ``remat_off`` and ``donate`` reach only their own
variant, where the reference's leak into every later variant of the call
through ``os.environ`` (ROADMAP R8, pinned here); the CLI.

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


def test_moe_disp_is_a_skipped_record_naming_the_sharded_plane():
    rec = hillclimb.run_variant("qwen2-moe-a2.7b", "train_4k", "moe_disp")
    assert rec["status"] == "skipped" and "item 1" in rec["reason"]
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["variant"]) == (
        "qwen2-moe-a2.7b", "train_4k", "1xH100", "moe_disp")


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


def test_cli_records_and_replaces_variants(monkeypatch, tmp_path, capsys):
    """Two ``ok`` records for ``baseline,ssd_bf16`` (the bf16-compute scan:
    the same FLOPs, other bytes: its plain backward in bf16); a variant run
    again replaces its record;
    ``--multi-pod`` is refused naming the sharded plane."""
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
    assert hillclimb.main(argv + ["--multi-pod"]) != 0
    assert "item 1" in capsys.readouterr().err


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
