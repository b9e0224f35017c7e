"""``examples/poisoning_study_torch.py`` on the CPU beside
``examples/poisoning_study.py`` (helpers and tolerances:
tests/torch_examples.py): four of its settings' curves, ``curve``, and
``main``'s JSON."""
import pytest
from torch_examples import (KW, SEEDS, check_defaults_to_the_card,
                            check_main_writes_its_json, close,
                            reference_driver, twin_driver)
from torch_parity import ref_init_task, single_threaded  # noqa: F401


def _settings(mod, cfg_cls):
    """(label, policies, scenario, omega, cfg): Fig. 3's constrained DQS,
    Fig. 2's top-value, the benign control, the baselines."""
    return [
        ("fig3_constrained_both", ["dqs"], mod._flip((6, 2)), (0.5, 0.5),
         cfg_cls(model_size_bits=5e6 * 8)),
        ("fig2_hard_div_only", ["top_value"], mod._flip((8, 4)),
         (0.0, 1.0), None),
        ("control_easy", ["dqs"], mod._control((6, 2), "easy_6to2"),
         (0.5, 0.5), None),
        ("baselines", ["random", "best_channel", "max_count"],
         mod._flip((6, 2)), (0.5, 0.5), cfg_cls(model_size_bits=5e6 * 8)),
    ]


@pytest.fixture(scope="module")
def ps_pair():
    """{label: (twin's curves, reference's curves)}."""
    from repro_torch.configs.base import FeelConfig
    twin = twin_driver("poisoning_study")
    ref = reference_driver("poisoning_study")
    task = ref_init_task()
    out = {}
    for (label, pols, scn, om, cfg), (_, _, rscn, _, rcfg) in zip(
            _settings(twin, FeelConfig), _settings(ref, ref.cfg.FeelConfig)):
        got = twin.curves(pols, scn, om, cfg, SEEDS, device="cpu",
                          tasks=[task], **KW)
        want = ref.curves(pols, rscn, om, rcfg, SEEDS, **KW)
        out[label] = got, want
    return out


@pytest.mark.parametrize("label", ["fig3_constrained_both",
                                   "fig2_hard_div_only", "control_easy",
                                   "baselines"])
def test_poisoning_study_curves_match_the_reference(ps_pair, label):
    got, want = ps_pair[label]
    close(got, want, label)


def test_poisoning_study_curve_is_its_curves():
    """``curve`` is one policy of ``curves``."""
    ps = twin_driver("poisoning_study")
    args = ("dqs", ps._flip((6, 2)), (0.5, 0.5), None, SEEDS)
    assert ps.curve(*args, device="cpu", **KW) == ps.curves(
        [args[0]], *args[1:], device="cpu", **KW)["dqs"]


@pytest.mark.parametrize("name", ["poisoning_study"])
def test_main_writes_only_its_json_with_the_reference_keys(
        ps_pair, name, tmp_path, monkeypatch):
    check_main_writes_its_json(name, tmp_path, monkeypatch,
                               entry=ps_pair["control_easy"][1]["dqs"])


@pytest.mark.parametrize("name", ["poisoning_study"])
def test_main_defaults_to_the_card(name, tmp_path, monkeypatch):
    check_defaults_to_the_card(name, tmp_path, monkeypatch)
