"""``examples/federated_llm_torch.py`` on the CPU beside
``examples/federated_llm.py`` (helpers and tolerances:
tests/torch_examples.py): leg 1 (DQS against random under vocabulary
collapse, seed 0, 2 rounds) from the reference's initial params and from
the port's own, both against one run of the reference's leg 1;
``loop_parity``'s bit-exact check; ``main``'s JSON. Legs 2 and 3 are
tests/test_torch_examples_federated_llm_engines.py's."""
import numpy as np
import pytest
from torch_examples import (check_defaults_to_the_card,
                            check_main_writes_its_json, close,
                            reference_lm_legs, twin_driver, twin_lm_legs)
from torch_parity import single_threaded  # noqa: F401


@pytest.fixture(scope="module")
def reference_leg_one():
    """The reference driver's ``dqs_vs_random([0], 2)``, computed once for
    the two tests that hold a twin's leg 1 against it."""
    return reference_lm_legs(["sweep"])["sweep"]


@pytest.mark.parametrize("leg", ["sweep"])
def test_federated_llm_legs_match_the_reference(reference_leg_one, leg):
    got = twin_lm_legs([leg])[leg]
    close(got, reference_leg_one, leg)


def test_fast_leg_one_margin_from_the_ports_init(reference_leg_one):
    """``dqs_vs_random`` at seed 0, 2 rounds: the port's own init (no
    injected params; tests/test_torch_init_parity.py holds that init
    against the reference's) against the reference driver's, the
    end-loss margin of the same sign and within 2e-2, each policy's end
    loss within 1e-2."""
    want = reference_leg_one
    got = twin_driver("federated_llm").dqs_vs_random([0], 2, device="cpu")
    assert np.sign(got["dqs_advantage"]) == np.sign(want["dqs_advantage"])
    assert abs(got["dqs_advantage"] - want["dqs_advantage"]) <= 2e-2
    for policy in ("dqs", "random"):
        np.testing.assert_allclose(got[policy]["end_loss_per_seed"],
                                   want[policy]["end_loss_per_seed"],
                                   atol=1e-2, rtol=0)


@pytest.mark.parametrize("key", ["loss", "acc", "malicious_selected"])
def test_loop_parity_holds_the_engines_bit_for_bit(key, monkeypatch):
    """The restored reference check: curves one ulp apart fail
    ``loop_parity`` on every device (no looser check for the card)."""
    fl = twin_driver("federated_llm")
    base = {"loss": [1.5, 1.25], "acc": [0.25, 0.5],
            "malicious_selected": [1, 0]}

    def fake(engine, **kw):
        out = {k: list(v) for k, v in base.items()}
        if engine == "loop":
            out[key][1] = float(np.nextafter(np.float32(out[key][1]),
                                             np.float32(2.0)))
        return out
    monkeypatch.setattr(fl, "run_experiment", fake)
    with pytest.raises(AssertionError, match=f"engine mismatch on {key}"):
        fl.loop_parity(2, device="cpu")
    monkeypatch.setattr(fl, "run_experiment",
                        lambda engine, **kw: {k: list(v)
                                              for k, v in base.items()})
    assert fl.loop_parity(2, device="cpu")["bit_exact"] is True
    assert not hasattr(fl, "CARD_LOSS_TOL")


@pytest.mark.parametrize("name", ["federated_llm"])
def test_main_writes_only_its_json_with_the_reference_keys(
        name, tmp_path, monkeypatch):
    check_main_writes_its_json(name, tmp_path, monkeypatch)


@pytest.mark.parametrize("name", ["federated_llm"])
def test_main_defaults_to_the_card(name, tmp_path, monkeypatch):
    check_defaults_to_the_card(name, tmp_path, monkeypatch)
