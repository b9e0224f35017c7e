"""``examples/federated_llm_torch.py``'s legs 2 (loop-engine parity,
1 round) and 3 (the flash-attention leg, 1 round; the reference's in
Pallas interpret mode) on the CPU beside ``examples/federated_llm.py``'s,
from the reference's initial params (helpers and tolerances:
tests/torch_examples.py). A file of their own, apart from leg 1
(tests/test_torch_examples_federated_llm.py), so that the test workers
run the two halves side by side."""
import pytest
from torch_examples import close, reference_lm_legs, twin_lm_legs
from torch_parity import single_threaded  # noqa: F401

LEGS = ["parity", "flash"]


@pytest.fixture(scope="module")
def lm_pair():
    """The two legs, twin and reference: ({leg: twin's}, {leg: ref's})."""
    return twin_lm_legs(LEGS), reference_lm_legs(LEGS)


@pytest.mark.parametrize("leg", LEGS)
def test_federated_llm_legs_match_the_reference(lm_pair, leg):
    got, want = lm_pair
    close(got[leg], want[leg], leg)
