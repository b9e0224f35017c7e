"""``examples/quickstart_torch.py`` on the CPU beside
``examples/quickstart.py`` (helpers and tolerances: tests/torch_examples.py):
the quickstart at 3,000/500 samples and 2 rounds, and ``main`` without
``--device``."""
import re

import pytest
from torch_examples import (KW, TOL, check_defaults_to_the_card,
                            reference_driver, twin_driver)
from torch_parity import ref_init_task, single_threaded  # noqa: F401

ROUND = re.compile(r"round (\d+): acc=([\d.]+) selected=(\d+) "
                   r"\(malicious among them: (\d+)\)")


def test_quickstart_matches_the_reference(monkeypatch, capsys):
    """The quickstart at 3,000/500 samples and 2 rounds: the attackers,
    each round's selection count and malicious count exact, accuracies
    within 1e-2; ``main`` hands back the rounds' logs."""
    ref = reference_driver("quickstart")
    real_gen = ref.generate
    monkeypatch.setattr(ref, "generate", lambda a, b, seed:
                        real_gen(KW["n_train"], KW["n_test"], seed=seed))
    monkeypatch.setattr(ref, "FeelConfig",
                        lambda rounds: ref.cfg.FeelConfig(rounds=2))
    ref.main()
    want = capsys.readouterr().out
    qs = twin_driver("quickstart")
    monkeypatch.setattr(qs, "N_TRAIN", KW["n_train"])
    monkeypatch.setattr(qs, "N_TEST", KW["n_test"])
    monkeypatch.setattr(qs, "ROUNDS", 2)
    task = ref_init_task()

    class Injected(qs.FeelServer):
        def __init__(self, *a, **k):
            super().__init__(*a, task=task, **k)

    monkeypatch.setattr(qs, "FeelServer", Injected)
    logs = qs.main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got.splitlines()[:2] == want.splitlines()[:2]
    g, w = ROUND.findall(got), ROUND.findall(want)
    assert len(g) == len(w) == len(logs) == 2
    for a, b, log in zip(g, w, logs):
        assert (a[0], a[2], a[3]) == (b[0], b[2], b[3])
        assert abs(float(a[1]) - float(b[1])) <= TOL + 1e-3
        assert int(a[2]) == log.selected.size


@pytest.mark.parametrize("name", ["quickstart"])
def test_main_defaults_to_the_card(name, tmp_path, monkeypatch):
    check_defaults_to_the_card(name, tmp_path, monkeypatch)
