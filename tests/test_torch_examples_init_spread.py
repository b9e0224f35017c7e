"""``examples/federated_llm_init_spread_torch.py`` on the CPU: offset 0 is
the driver's leg 1, another offset moves only the initial params, and
``main`` without ``--device`` raises where CUDA is absent."""
import json

import numpy as np
import pytest
import torch
from torch_examples import load
from torch_parity import single_threaded  # noqa: F401


def test_init_spread_moves_only_the_initial_params(tmp_path, monkeypatch):
    """``examples/federated_llm_init_spread_torch.py``: offset 0 is the
    driver's leg 1 (its end losses), another offset draws other initial
    params and so other losses; ``main`` writes only its JSON, whose
    summary is that of the margins it prints."""
    spread = load("federated_llm_init_spread_torch", "twin")
    monkeypatch.setattr(spread.fl, "FAST", ([0], 1, 1))
    monkeypatch.chdir(tmp_path)
    leg = spread.fl.dqs_vs_random([0], 1, device="cpu")
    out = spread.main(["--offsets", "0", "1", "--device", "cpu"])
    zero, one = out["offsets"]["0"], out["offsets"]["1"]
    for policy in ("dqs", "random"):
        np.testing.assert_allclose(zero["end_loss"][policy],
                                   leg[policy]["end_loss_per_seed"],
                                   atol=5e-5, rtol=0)
        assert one["end_loss"][policy] != zero["end_loss"][policy]
    assert abs(zero["margin"] - leg["dqs_advantage"]) <= 1e-4
    margins = [zero["margin"], one["margin"]]
    assert out["mean"] == pytest.approx(np.mean(margins))
    assert out["negative"] == sum(m < 0 for m in margins)
    written = [p.relative_to(tmp_path).as_posix()
               for p in tmp_path.rglob("*") if p.is_file()]
    assert written == ["results/federated_llm_init_spread_torch.json"]
    assert json.loads((tmp_path / written[0]).read_text()) == out


def test_init_spread_defaults_to_the_card(tmp_path, monkeypatch):
    spread = load("federated_llm_init_spread_torch", "twin")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        spread.main([])
    assert not any(tmp_path.iterdir())
