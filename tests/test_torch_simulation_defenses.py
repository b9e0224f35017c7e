"""Every registered defense through the port's ``run_experiment`` under the
``noise_0.8`` feature-noise scenario, against the reference's
``run_experiment(..., control="host")`` — the trimmed mean and median
through ``robust_aggregate``'s plain version, norm clipping and Krum
through ``weighted_aggregate``'s, the validation detector's penalty into
Eq. 1. Exact and toleranced fields as in tests/test_torch_simulation.py."""
import numpy as np
import pytest
from torch_parity import single_threaded  # noqa: F401
from test_torch_simulation import (check_against_reference,
                                   check_engines_agree, run_triple)

DEFENSES = ["none", "trimmed_mean", "median", "norm_clip", "krum",
            "validation", "trimmed_mean+validation"]


@pytest.fixture(scope="module")
def defense_runs():
    return {}


def _runs(cache, name):
    if name not in cache:
        cache[name] = run_triple(scenario="noise_0.8", defense=name)
    return cache[name]


def test_defense_list_is_the_registry():
    from repro_torch.core.defenses import DEFENSES as REGISTRY
    assert sorted(DEFENSES) == sorted(REGISTRY)


@pytest.mark.parametrize("name", DEFENSES)
def test_defense_matches_reference(defense_runs, name):
    out = _runs(defense_runs, name)
    check_against_reference(out)
    got = out["vectorized"][0]
    assert got["defense"] == name
    if name in ("trimmed_mean", "median", "krum",
                "trimmed_mean+validation"):
        assert all(n > 0 for n in got["n_rejected"])
    assert out["launches"] == (0, 0)


@pytest.mark.parametrize("name", DEFENSES)
def test_defense_engines_agree(defense_runs, name):
    check_engines_agree(_runs(defense_runs, name))


@pytest.mark.parametrize("name", ["validation", "trimmed_mean+validation"])
def test_detector_flags_and_penalty_match_reference(name):
    """Seed 2 flags an upload in round 1, so the detector's trust penalty
    enters Eq. 1: flags, detection stats and selections exact,
    reputations within 5e-2."""
    out = run_triple(scenario="noise_0.8", defense=name, seed=2)
    check_against_reference(out)
    check_engines_agree(out)
    assert out["vectorized"][0]["n_flagged"][1] > 0
    reps = [l.reputations for l in out["vectorized"][1].logs]
    reps_r = [l.reputations for l in out["ref"][1].logs]
    np.testing.assert_allclose(reps, reps_r, atol=5e-2)
