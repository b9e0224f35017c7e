"""``examples/robustness_extensions_torch.py`` on the CPU beside
``examples/robustness_extensions.py`` (helpers and tolerances:
tests/torch_examples.py): the scenario x defense matrix, the omega
curves, and ``main``'s JSON."""
import pytest
from torch_examples import (KW, SEEDS, check_defaults_to_the_card,
                            check_main_writes_its_json, close,
                            reference_driver, twin_driver)
from torch_parity import ref_init_task, single_threaded  # noqa: F401


@pytest.fixture(scope="module")
def rb_pair():
    """The scenario x defense matrix and the curves, twin and reference."""
    from repro_torch.configs.base import FeelConfig
    twin = twin_driver("robustness_extensions")
    rb = reference_driver("robustness_extensions")
    task = ref_init_task()
    cfg5 = FeelConfig(model_size_bits=5e6 * 8)
    got = twin.matrix(SEEDS, cfg5, device="cpu", tasks=[task], **KW)
    rcfg5 = rb.cfg.FeelConfig(model_size_bits=5e6 * 8)
    res = rb.run_sweep(["dqs", "random"], seeds=SEEDS,
                       scenarios=rb.SCENARIO_MATRIX,
                       defenses=["none", "trimmed_mean+validation"],
                       cfg=rcfg5, **KW)
    want = dict(rb.summarize(res, scn.name, policy, defense)
                for scn in rb.SCENARIO_MATRIX
                for defense in ("none", "trimmed_mean+validation")
                for policy in ("dqs", "random"))
    curves = {}
    for tag, kw, rkw in (
            ("fixed_omega", dict(cfg=cfg5), dict(cfg=rcfg5)),
            ("adaptive_omega", dict(cfg=cfg5, adaptive_omega=True),
             dict(cfg=rcfg5, adaptive_omega=True))):
        curves[tag] = (
            twin.curve(tag, SEEDS, device="cpu", policy="dqs",
                       attack_pair=(8, 4), task=task, **kw, **KW),
            rb.curve(tag, SEEDS, policy="dqs", attack_pair=(8, 4),
                     **rkw, **KW))
    return got, want, curves


def test_robustness_matrix_matches_the_reference(rb_pair):
    """Every cell of the 9 scenarios x 2 defenses x 2 policies."""
    got, want, _ = rb_pair
    assert list(got) == list(want) and len(got) == 36
    for tag in want:
        close(got[tag], want[tag], tag)


@pytest.mark.parametrize("tag", ["fixed_omega", "adaptive_omega"])
def test_robustness_curves_match_the_reference(rb_pair, tag):
    got, want = rb_pair[2][tag]
    close(got, want, tag)


@pytest.mark.parametrize("name", ["robustness_extensions"])
def test_main_writes_only_its_json_with_the_reference_keys(
        name, tmp_path, monkeypatch):
    check_main_writes_its_json(name, tmp_path, monkeypatch)


@pytest.mark.parametrize("name", ["robustness_extensions"])
def test_main_defaults_to_the_card(name, tmp_path, monkeypatch):
    check_defaults_to_the_card(name, tmp_path, monkeypatch)
